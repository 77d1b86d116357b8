"""A small tree-walking Lua evaluator for configuration files.

Port of cartographer_tpu/common/lua.py.

Reference: common/lua_parameter_dictionary.cc embeds Lua 5.2. The
configuration dialect the reference ships and documents
(configuration_files/*.lua) is declarative: `include "file"` directives,
(dotted) assignments, table constructors, arithmetic, strings, booleans,
and `math.*` helpers. This module implements that dialect with a real
tokenizer + recursive-descent parser — unlike a regex translation it is
robust to comments and separators inside strings, long comments
(`--[[ ]]`), multi-line expressions, and nested includes.

Not a general Lua: no functions, loops, or metatables — a config using
those raises a clear LuaError instead of being silently mis-parsed.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["LuaError", "evaluate", "evaluate_file"]


class LuaError(Exception):
    pass


_KEYWORDS = {
    "true", "false", "nil", "include", "local", "return", "and", "or",
    "not", "function", "end", "if", "then", "else", "for", "while",
}

_SYMBOLS = (
    "...", "..", "==", "~=", "<=", ">=", "=", "{", "}", "(", ")", "[",
    "]", ",", ";", ".", "+", "-", "*", "/", "%", "^", "<", ">", "#",
)


def _tokenize(text: str, where: str) -> List[Tuple[str, Any, int]]:
    """Returns (kind, value, line) tokens. Kinds: NAME, NUMBER, STRING,
    KEYWORD, SYM, EOF."""
    tokens: List[Tuple[str, Any, int]] = []
    i, n, line = 0, len(text), 1

    def err(msg):
        raise LuaError(f"{where}:{line}: {msg}")

    while i < n:
        c = text[i]
        if c == "\n":
            line += 1
            i += 1
            continue
        if c in " \t\r":
            i += 1
            continue
        if text.startswith("--", i):
            if text.startswith("--[[", i):
                end = text.find("]]", i + 4)
                if end < 0:
                    err("unterminated long comment")
                line += text.count("\n", i, end)
                i = end + 2
            else:
                end = text.find("\n", i)
                i = n if end < 0 else end
            continue
        if c in "'\"":
            quote = c
            j = i + 1
            buf = []
            while j < n and text[j] != quote:
                ch = text[j]
                if ch == "\n":
                    err("unterminated string")
                if ch == "\\":
                    j += 1
                    if j >= n:
                        err("unterminated string escape")
                    esc = text[j]
                    buf.append(
                        {"n": "\n", "t": "\t", "r": "\r", "\\": "\\",
                         "'": "'", '"': '"'}.get(esc, esc)
                    )
                else:
                    buf.append(ch)
                j += 1
            if j >= n:
                err("unterminated string")
            tokens.append(("STRING", "".join(buf), line))
            i = j + 1
            continue
        if c.isdigit() or (
            c == "." and i + 1 < n and text[i + 1].isdigit()
        ):
            j = i
            if text.startswith("0x", i) or text.startswith("0X", i):
                j = i + 2
                while j < n and text[j] in "0123456789abcdefABCDEF":
                    j += 1
                tokens.append(("NUMBER", float(int(text[i:j], 16)), line))
                i = j
                continue
            seen_dot = seen_exp = False
            while j < n:
                ch = text[j]
                if ch.isdigit():
                    j += 1
                elif ch == "." and not seen_dot and not seen_exp:
                    seen_dot = True
                    j += 1
                elif ch in "eE" and not seen_exp:
                    seen_exp = True
                    j += 1
                    if j < n and text[j] in "+-":
                        j += 1
                else:
                    break
            tokens.append(("NUMBER", float(text[i:j]), line))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (text[j].isalnum() or text[j] == "_"):
                j += 1
            word = text[i:j]
            tokens.append(
                ("KEYWORD" if word in _KEYWORDS else "NAME", word, line)
            )
            i = j
            continue
        for sym in _SYMBOLS:
            if text.startswith(sym, i):
                tokens.append(("SYM", sym, line))
                i += len(sym)
                break
        else:
            err(f"unexpected character {c!r}")
    tokens.append(("EOF", None, line))
    return tokens


def _std_env() -> Dict[str, Any]:
    return {
        "math": {
            "rad": math.radians,
            "deg": math.degrees,
            "floor": math.floor,
            "ceil": math.ceil,
            "sqrt": math.sqrt,
            "abs": abs,
            "min": min,
            "max": max,
            "huge": math.inf,
            "pi": math.pi,
        },
        "tonumber": float,
        "tostring": str,
    }


class _Parser:
    """Statement-at-a-time evaluator (the config dialect needs no AST)."""

    def __init__(
        self,
        tokens: List[Tuple[str, Any, int]],
        env: Dict[str, Any],
        where: str,
        resolve_include: Optional[Callable[[str], None]],
    ):
        self.toks = tokens
        self.pos = 0
        self.env = env
        self.where = where
        self.resolve_include = resolve_include
        self.returned: Any = None

    # -- token helpers ------------------------------------------------------
    def peek(self):
        return self.toks[self.pos]

    def next(self):
        t = self.toks[self.pos]
        self.pos += 1
        return t

    def err(self, msg):
        kind, val, line = self.peek()
        raise LuaError(f"{self.where}:{line}: {msg} (at {val!r})")

    def accept(self, kind, value=None):
        k, v, _ = self.peek()
        if k == kind and (value is None or v == value):
            return self.next()
        return None

    def expect(self, kind, value=None):
        t = self.accept(kind, value)
        if t is None:
            self.err(f"expected {value or kind}")
        return t

    # -- statements ---------------------------------------------------------
    def run(self):
        while True:
            k, v, _ = self.peek()
            if k == "EOF":
                return
            if k == "SYM" and v == ";":
                self.next()
                continue
            if k == "KEYWORD" and v == "include":
                self.next()
                name = self.expect("STRING")[1]
                if self.resolve_include is None:
                    raise LuaError(
                        f"{self.where}: include not allowed here"
                    )
                self.resolve_include(name)
                continue
            if k == "KEYWORD" and v == "return":
                self.next()
                self.returned = self.expr()
                k2, v2, _ = self.peek()
                if not (k2 == "EOF" or (k2 == "SYM" and v2 == ";")):
                    self.err("return must end the chunk")
                return
            if k == "KEYWORD" and v == "local":
                self.next()
                name = self.expect("NAME")[1]
                self.expect("SYM", "=")
                self.env[name] = self.expr()
                continue
            if k == "NAME":
                self.assignment()
                continue
            self.err("expected a statement")

    def assignment(self):
        name = self.expect("NAME")[1]
        target = None
        key: Any = name
        container: Any = self.env
        while True:
            if self.accept("SYM", "."):
                container = self._read(container, key)
                key = self.expect("NAME")[1]
            elif self.accept("SYM", "["):
                container = self._read(container, key)
                key = self.expr()
                if isinstance(key, float) and key.is_integer():
                    key = int(key)
                self.expect("SYM", "]")
            else:
                break
        self.expect("SYM", "=")
        value = self.expr()
        if not isinstance(container, dict):
            self.err(f"cannot assign into non-table {name!r}")
        container[key] = value

    def _read(self, container, key):
        if not isinstance(container, dict) or key not in container:
            self.err(f"undefined name {key!r}")
        return container[key]

    # -- expressions (precedence climbing) ----------------------------------
    def expr(self):
        return self.expr_or()

    def expr_or(self):
        left = self.expr_and()
        while self.accept("KEYWORD", "or"):
            right = self.expr_and()
            left = left if _truthy(left) else right
        return left

    def expr_and(self):
        left = self.expr_cmp()
        while self.accept("KEYWORD", "and"):
            right = self.expr_cmp()
            left = right if _truthy(left) else left
        return left

    def expr_cmp(self):
        left = self.expr_concat()
        while True:
            t = self.peek()
            if t[0] == "SYM" and t[1] in ("==", "~=", "<", ">", "<=", ">="):
                op = self.next()[1]
                right = self.expr_concat()
                left = {
                    "==": lambda a, b: a == b,
                    "~=": lambda a, b: a != b,
                    "<": lambda a, b: a < b,
                    ">": lambda a, b: a > b,
                    "<=": lambda a, b: a <= b,
                    ">=": lambda a, b: a >= b,
                }[op](left, right)
            else:
                return left

    def expr_concat(self):
        left = self.expr_add()
        if self.accept("SYM", ".."):
            right = self.expr_concat()
            return _lua_str(left) + _lua_str(right)
        return left

    def expr_add(self):
        left = self.expr_mul()
        while True:
            if self.accept("SYM", "+"):
                left = left + self.expr_mul()
            elif self.accept("SYM", "-"):
                left = left - self.expr_mul()
            else:
                return left

    def expr_mul(self):
        left = self.expr_unary()
        while True:
            if self.accept("SYM", "*"):
                left = left * self.expr_unary()
            elif self.accept("SYM", "/"):
                left = left / self.expr_unary()
            elif self.accept("SYM", "%"):
                left = left % self.expr_unary()
            else:
                return left

    def expr_unary(self):
        if self.accept("SYM", "-"):
            return -self.expr_unary()
        if self.accept("KEYWORD", "not"):
            return not _truthy(self.expr_unary())
        return self.expr_pow()

    def expr_pow(self):
        base = self.primary()
        if self.accept("SYM", "^"):
            return base ** self.expr_unary()  # right-assoc
        return base

    def primary(self):
        k, v, _ = self.peek()
        if k == "NUMBER" or k == "STRING":
            self.next()
            return v
        if k == "KEYWORD" and v in ("true", "false", "nil"):
            self.next()
            return {"true": True, "false": False, "nil": None}[v]
        if k == "SYM" and v == "(":
            self.next()
            val = self.expr()
            self.expect("SYM", ")")
            return val
        if k == "SYM" and v == "{":
            return self.table()
        if k == "NAME":
            return self.suffixed()
        self.err("expected an expression")

    def suffixed(self):
        name = self.expect("NAME")[1]
        value = self._read(self.env, name)
        while True:
            if self.accept("SYM", "."):
                key = self.expect("NAME")[1]
                value = self._read(value, key)
            elif self.accept("SYM", "["):
                key = self.expr()
                if isinstance(key, float) and key.is_integer():
                    key = int(key)
                self.expect("SYM", "]")
                value = self._read(value, key)
            elif self.accept("SYM", "("):
                args = []
                if not self.accept("SYM", ")"):
                    args.append(self.expr())
                    while self.accept("SYM", ","):
                        args.append(self.expr())
                    self.expect("SYM", ")")
                if not callable(value):
                    self.err("calling a non-function")
                value = value(*args)
            else:
                return value

    def table(self):
        self.expect("SYM", "{")
        out: Dict[Any, Any] = {}
        array_index = 1
        while True:
            if self.accept("SYM", "}"):
                return out
            k, v, _ = self.peek()
            if k == "NAME" and self.toks[self.pos + 1][:2] == ("SYM", "="):
                key = self.next()[1]
                self.next()  # '='
                out[key] = self.expr()
            elif k == "SYM" and v == "[":
                self.next()
                key = self.expr()
                if isinstance(key, float) and key.is_integer():
                    key = int(key)
                self.expect("SYM", "]")
                self.expect("SYM", "=")
                out[key] = self.expr()
            else:
                out[array_index] = self.expr()
                array_index += 1
            if not (self.accept("SYM", ",") or self.accept("SYM", ";")):
                self.expect("SYM", "}")
                return out


def _truthy(v) -> bool:
    return v is not None and v is not False


def _lua_str(v) -> str:
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    if v is True:
        return "true"
    if v is False:
        return "false"
    return str(v)


def evaluate(
    code: str,
    env: Optional[Dict[str, Any]] = None,
    where: str = "<lua>",
    resolve_include: Optional[Callable[[str], None]] = None,
) -> Tuple[Dict[str, Any], Any]:
    """Evaluate a chunk; returns (globals dict, `return` value or None)."""
    if env is None:
        env = _std_env()
    parser = _Parser(_tokenize(code, where), env, where, resolve_include)
    parser.run()
    return env, parser.returned


def evaluate_file(
    filename: str,
    include_dirs: List[str],
    env: Optional[Dict[str, Any]] = None,
) -> Tuple[Dict[str, Any], Any]:
    """Evaluate a file with `include` resolution over include_dirs (the
    ConfigurationFileResolver, configuration_file_resolver.cc:36-56)."""
    import os

    if env is None:
        env = _std_env()
    path = None
    for d in include_dirs:
        candidate = os.path.join(d, filename)
        if os.path.exists(candidate):
            path = candidate
            break
    if path is None:
        raise FileNotFoundError(
            f"config file {filename!r} not in {include_dirs}"
        )

    ret: List[Any] = [None]

    def resolve(name: str) -> None:
        evaluate_file(name, include_dirs, env)

    with open(path) as f:
        _, returned = evaluate(f.read(), env, path, resolve)
    ret[0] = returned
    return env, ret[0]

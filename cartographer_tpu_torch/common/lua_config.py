"""Loader for the reference's Lua configuration files.

Port of cartographer_tpu/common/lua_config.py.

Reference: common/lua_parameter_dictionary.cc + configuration_file_resolver.cc
— Lua 5.2 evaluates config files into nested dictionaries with
include-resolution, and every key must be READ by the consuming options
factory or loading fails (reference counting in
lua_parameter_dictionary.h — the reference's main defense against
config typos). Here the files are evaluated by the real tokenizer/parser
in common/lua.py (robust to `--`/`;` inside strings, long comments,
multi-line expressions, nested includes), and the unread-key check is
enforced against the typed dataclass schema of common/config.py: keys
the options classes do not consume raise LuaConfigError unless
strict=False.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from cartographer_tpu_torch.common import config as config_module
from cartographer_tpu_torch.common import lua as lua_module
from cartographer_tpu_torch.common.lua import LuaError  # re-export  # noqa: F401


class LuaConfigError(Exception):
    """A config key the options schema does not consume (typo defense)."""


def load_lua_file(
    filename: str, include_dirs: List[str], env: Optional[Dict[str, Any]] = None
) -> Dict[str, Any]:
    """Evaluate a Lua config file; returns the resulting global table dict."""
    env, _ = lua_module.evaluate_file(filename, include_dirs, env)
    return {
        k: v
        for k, v in env.items()
        if k not in ("math", "tonumber", "tostring")
    }


def load_lua_code(code: str) -> Dict[str, Any]:
    """Evaluate inline Lua (no includes); returns `return`'s table if the
    chunk returns one, else the globals table."""
    env, returned = lua_module.evaluate(code)
    if returned is not None:
        return returned
    return {
        k: v
        for k, v in env.items()
        if k not in ("math", "tonumber", "tostring")
    }


# -- conversion into the typed dataclass options ----------------------------

# Directories searched after the caller's. The JAX module names one fixed
# absolute path outside any checkout; the port reads only the directories
# its caller names, so a reference configuration set is passed the same way
# as any other (`include_dirs`, `--configuration_directory`).
_REFERENCE_DIRS: List[str] = []


def _collect_unread(cls, data: dict, prefix: str, unread: List[str]) -> dict:
    """Split `data` into (consumed subtree, unread key paths). A key is
    consumed iff the dataclass schema has a field for it (recursively) —
    the unread list is the reference's reference-count residue."""
    field_names = {f.name for f in dataclasses.fields(cls)}
    out = {}
    for key, value in data.items():
        path = f"{prefix}{key}"
        if key not in field_names:
            unread.append(path)
            continue
        default = config_module._default_of(cls, key)
        if dataclasses.is_dataclass(default) and isinstance(value, dict):
            out[key] = _collect_unread(
                type(default), value, path + ".", unread
            )
        elif (
            default is None
            and isinstance(value, dict)
            and key in config_module._OPTIONAL_NESTED
        ):
            out[key] = _collect_unread(
                config_module._OPTIONAL_NESTED[key], value, path + ".", unread
            )
        else:
            out[key] = value
    return out


def _convert(cls, options: dict, strict: bool, root: str):
    if options is None:
        raise LuaConfigError(f"config defines no {root} table")
    unread: List[str] = []
    consumed = _collect_unread(cls, options, f"{root}.", unread)
    if strict and unread:
        raise LuaConfigError(
            "unread config keys (typo or unsupported option): "
            + ", ".join(sorted(unread))
        )
    return cls.from_dict(consumed)


def load_map_builder_options(
    lua_code_or_file: str,
    include_dirs: Optional[List[str]] = None,
    strict: bool = True,
) -> config_module.MapBuilderOptions:
    include_dirs = (include_dirs or []) + _REFERENCE_DIRS
    table = load_lua_file(lua_code_or_file, include_dirs)
    options = table.get("MAP_BUILDER", table.get("options"))
    return _convert(
        config_module.MapBuilderOptions, options, strict, "MAP_BUILDER"
    )


def load_trajectory_builder_options(
    lua_code_or_file: str,
    include_dirs: Optional[List[str]] = None,
    strict: bool = True,
) -> config_module.TrajectoryBuilderOptions:
    include_dirs = (include_dirs or []) + _REFERENCE_DIRS
    table = load_lua_file(lua_code_or_file, include_dirs)
    options = table.get("TRAJECTORY_BUILDER", table.get("options"))
    return _convert(
        config_module.TrajectoryBuilderOptions,
        options,
        strict,
        "TRAJECTORY_BUILDER",
    )

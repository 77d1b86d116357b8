"""Build `csrc/<name>.cu` with nvcc, or `csrc/<name>.cc` with the host C++
compiler, into a shared library with a plain C interface, and load it
with ctypes.

Each source becomes `.build/<name>-<hash>.so` inside this package, where
the hash covers the source, the headers beside it and the compiler flags
(for host code also the CPU model and flags, since it is built with
-march=native); an unchanged source is never rebuilt. The build runs at
first use (never at import) and a failed build raises with the
compiler's output. `build_all()` starts one compiler per source at once,
for callers that want every library ready before they start timing, and
returns the compilers' output (for CUDA sources with ptxas's registers
and spills per kernel, `-Xptxas -v`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / ".build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

HOST_CXX_FLAGS = [
    "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread",
]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Names of every source under csrc/ (CUDA .cu and host .cc)."""
    return sorted(p.stem for p in [*CSRC.glob("*.cu"), *CSRC.glob("*.cc")])


def _source(name: str) -> Path:
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.cc"


def _host_cxx() -> str:
    for cc in ("g++", "c++", "clang++"):
        found = shutil.which(cc)
        if found:
            return found
    raise RuntimeError("no host C++ compiler found: csrc/*.cc cannot be built")


def _cpu_fingerprint() -> bytes:
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return b""
    keep = [l for l in lines if l.startswith(("model name", "flags"))][:2]
    return "\n".join(keep).encode()


def _command(name: str, out: Path) -> List[str]:
    src = _source(name)
    if src.suffix == ".cu":
        return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]
    return [_host_cxx(), *HOST_CXX_FLAGS, str(src), "-o", str(out)]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _library_path(name: str) -> Path:
    src = _source(name)
    if src.suffix == ".cu":
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        headers = sorted(CSRC.glob("*.cuh"))
    else:
        h = hashlib.sha256(" ".join(HOST_CXX_FLAGS).encode())
        h.update(_cpu_fingerprint())
        headers = sorted(CSRC.glob("*.h"))
    h.update(src.read_bytes())
    for header in headers:
        h.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start the compiler for one source; returns (process, tmp path,
    final path), or None when the library is already built."""
    out = _library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = _command(name, tmp)
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(name: str, started) -> str:
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {_source(name).relative_to(_PKG)} failed:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return log


def build_all() -> Dict[str, str]:
    """Build every source under csrc/, one compiler per source, all at
    once. Returns the compiler's output for each source it built (none
    for a library that was already built)."""
    with _lock:
        started = {n: _start(n) for n in sources()}
        return {
            name: _finish(name, s) for name, s in started.items() if s is not None
        }


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu or .cc, building it if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            started = _start(name)
            if started is not None:
                _finish(name, started)
            lib = ctypes.CDLL(str(_library_path(name)))
            _loaded[name] = lib
        return lib

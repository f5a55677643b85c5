"""nvcc build of the port's hand-written CUDA kernels.

Each source in csrc/ compiles with nvcc for sm_90a into a shared library
with a plain C interface, at first use, into this package's build/
directory (ignored by git), and is loaded with ctypes by its wrapper
module (ops/word_kernel_cuda.py, ops/match_fast_cuda.py,
ops/text_features_cuda.py, ops/commit_cuda.py).  A library is rebuilt
when it is older than its source or than any header the source includes
from csrc/, directly or through another header.  Nothing is compiled at
module import.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
# build/ is listed in .gitignore: a library is built on the machine that
# runs it, never committed.
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")
    return found


_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def local_includes(source: str) -> list[str]:
    """The files `source` includes with quotes, found beside the file that
    names them, directly or through another such header, each once."""
    seen: list[str] = []
    todo = [source]
    while todo:
        path = todo.pop()
        with open(path, encoding="utf-8") as f:
            names = _INCLUDE.findall(f.read())
        for name in names:
            dep = os.path.normpath(os.path.join(os.path.dirname(path), name))
            if os.path.exists(dep) and dep not in seen:
                seen.append(dep)
                todo.append(dep)
    return seen


def is_stale(source: str, library: str) -> bool:
    """Whether `library` is missing or older than `source` or one of its
    local includes."""
    if not os.path.exists(library):
        return True
    built = os.path.getmtime(library)
    return any(os.path.getmtime(p) > built for p in [source, *local_includes(source)])


def aligned16(t):
    """t, or a copy of it where its data does not start on 16 bytes (the
    kernels load 16 bytes at a time); a fresh allocation is aligned."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def operand(name: str, t, dtype, size: int):
    """t as a kernel reads it: one-dimensional, contiguous, 16-byte aligned,
    of `dtype` and `size` elements; raises on another shape."""
    if t.dim() != 1 or t.shape[0] != size:
        raise ValueError(f"{name}: expected [{size}], got {list(t.shape)}")
    return aligned16(t.to(dtype).contiguous())


def build_library(source: str, library: str, *, force: bool = False):
    """Compile `source` into `library` (if the library is stale, see
    is_stale, or `force`) and load it.  Returns (the ctypes library,
    nvcc's output of this build or None when nothing was built); raises if
    nvcc fails.  The caller serialises calls for one library."""
    log = None
    if force or is_stale(source, library):
        os.makedirs(os.path.dirname(library), exist_ok=True)
        tmp = f"{library}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, source]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{log}")
        os.replace(tmp, library)
    return ctypes.CDLL(library), log

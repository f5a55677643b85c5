"""nvcc build of the port's hand-written CUDA kernels.

Each source in csrc/ compiles with nvcc for sm_90a into a shared library
with a plain C interface, at first use, into this package's build/
directory (ignored by git), and is loaded with ctypes by its wrapper
module (ops/word_kernel_cuda.py, ops/match_fast_cuda.py).  Nothing is
compiled at module import.
"""

from __future__ import annotations

import ctypes
import os
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


def build_library(source: str, library: str, *, force: bool = False):
    """Compile `source` into `library` (if the library is missing, older
    than the source, or `force`) and load it.  Returns (the ctypes
    library, nvcc's output of this build or None when nothing was built);
    raises if nvcc fails.  The caller serialises calls for one library."""
    log = None
    if force or not os.path.exists(library) or os.path.getmtime(library) < os.path.getmtime(source):
        os.makedirs(os.path.dirname(library), exist_ok=True)
        tmp = f"{library}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, source]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{log}")
        os.replace(tmp, library)
    return ctypes.CDLL(library), log

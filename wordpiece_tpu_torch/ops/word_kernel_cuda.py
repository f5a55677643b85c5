"""Wrappers of the hand-written CUDA word match+commit kernel.

The kernel (csrc/word_kernel.cu) replaces the TPU kernel
wordpiece_tpu/ops/word_kernel_pallas.py::_kernel.  It is compiled with
nvcc for sm_90a into a library with a plain C interface, at first use,
into this package's build/ directory (ignored by git), and loaded with
ctypes.  Nothing here is compiled or imported from CUDA at module import.

Each wrapper takes the plain version (ops/word_kernel.py) only for
tensors that lie on the CPU.  For a CUDA tensor it launches the kernel
on the current stream, or raises; it never falls back.
`word_match_commit_bucket.launches` counts the kernel's launches.

Layouts:
  - a bucket is a narrow unit matrix uint8/uint16/int32[U, W] (W = the
    bucket width, contiguous); columns >= W read as space;
  - the emit matrix is int32[U, W]: a token id per emitting position,
    -2 elsewhere;
  - the compact vector (word_match_commit_compact) is int32[1 + U_total
    + cap]: the total id count, the per-unit counts of every bucket in
    order, then (token_id + 2) * 128 + position for every emitted id in
    (bucket, unit, position) order, capped at `cap` entries.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import numpy as np
import torch

from ..core.length_tables import DeviceTables
from .word_kernel import word_match_commit

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "word_kernel.cu")
# build/ is listed in .gitignore: the library is built on the machine that
# runs it, never committed.
BUILD_DIR = os.path.join(_PKG, "build")
LIBRARY = os.path.join(BUILD_DIR, "libword_kernel.so")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIB = None
build_log = ""  # nvcc's output of the last build (ptxas -v: regs, smem, spills)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA word kernel cannot be built")
    return found


def build(*, force: bool = False):
    """Compile csrc/word_kernel.cu (if the library is missing, older than
    the source, or `force`) and load it.  Returns the ctypes library;
    raises if nvcc fails."""
    global _LIB, build_log
    with _LOCK:
        if _LIB is not None and not force:
            return _LIB
        stale = (
            force
            or not os.path.exists(LIBRARY)
            or os.path.getmtime(LIBRARY) < os.path.getmtime(SOURCE)
        )
        if stale:
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{LIBRARY}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE]
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
            build_log = res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{build_log}")
            os.replace(tmp, LIBRARY)
        lib = ctypes.CDLL(LIBRARY)
        fn = lib.wp_word_match_commit
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p,  # cp
            ctypes.c_int,  # bytes per codepoint
            ctypes.c_longlong,  # n_units
            ctypes.c_int,  # width
            ctypes.c_void_p,  # packed tables int4[R, 128]
            ctypes.c_void_p,  # rows_off int32[max_len + 2]
            ctypes.c_void_p,  # lane_salts uint32[max_len + 1]
            ctypes.c_int,  # max_len
            ctypes.c_uint,  # mult1
            ctypes.c_uint,  # mult2
            ctypes.c_int,  # unk_id
            ctypes.c_void_p,  # out int32[U, W]
            ctypes.c_void_p,  # cudaStream_t
        ]
        _LIB = lib
        return lib


_CP_DTYPES = (torch.uint8, torch.uint16, torch.int32)


def word_match_commit_bucket(cp: torch.Tensor, tables: DeviceTables) -> torch.Tensor:
    """One bucket: narrow unit matrix [U, W] -> emit int32[U, W]."""
    if cp.dim() != 2:
        raise ValueError(f"unit matrix must be 2-D, got shape {tuple(cp.shape)}")
    width = int(cp.shape[1])
    if tables.packed.device != cp.device:
        raise ValueError(f"tables on {tables.packed.device}, units on {cp.device}")
    if cp.device.type == "cpu":
        return word_match_commit(
            cp, tables.k1, tables.k2, tables.tid, width=width, **tables.statics
        )
    if cp.device.type != "cuda":
        raise ValueError(f"unsupported device {cp.device}")
    if cp.dtype not in _CP_DTYPES:
        raise TypeError(f"unit matrix dtype {cp.dtype} not in {_CP_DTYPES}")
    if not cp.is_contiguous():
        raise ValueError("unit matrix must be contiguous")
    if not 1 <= width <= 255:
        raise ValueError(f"width {width} outside the kernel's 1..255")
    n_units = int(cp.shape[0])
    out = torch.empty((n_units, width), dtype=torch.int32, device=cp.device)
    if n_units == 0:
        return out
    lib = build()
    rc = lib.wp_word_match_commit(
        cp.data_ptr(),
        cp.element_size(),
        n_units,
        width,
        tables.packed.data_ptr(),
        tables.rows_off_t.data_ptr(),
        tables.lane_salts_t.data_ptr(),
        tables.max_len,
        tables.mult1 & 0xFFFFFFFF,
        tables.mult2 & 0xFFFFFFFF,
        tables.unk_id,
        out.data_ptr(),
        torch.cuda.current_stream(cp.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"word_match_commit kernel launch failed: CUDA error {rc}")
    word_match_commit_bucket.launches += 1
    return out


word_match_commit_bucket.launches = 0


def word_match_commit_multi(cps, tables: DeviceTables) -> list[torch.Tensor]:
    """Every bucket's emit matrix (one kernel launch per bucket)."""
    return [word_match_commit_bucket(cp, tables) for cp in cps]


def compact_emits(emits, cap: int) -> torch.Tensor:
    """Emit matrices -> the compact vector (module docstring), with torch
    ops on the emits' device and no host synchronisation."""
    dev = emits[0].device
    counts = torch.cat([(e != -2).sum(dim=1, dtype=torch.int32) for e in emits])
    n = counts.shape[0]
    out = torch.empty(1 + n + cap + 1, dtype=torch.int32, device=dev)
    out[1 : 1 + n] = counts
    ends = torch.cumsum(counts, 0, dtype=torch.int64)
    out[0:1] = ends[-1:] if n else 0
    starts = ends - counts
    dummy = 1 + n + cap  # the one slot that takes every dropped entry
    base = 0
    for e in emits:
        u, w = e.shape
        if w > 128:
            raise ValueError(f"width {w}: positions must fit the 7-bit field")
        if u == 0:
            continue
        mask = e != -2
        dest = starts[base : base + u, None] + (torch.cumsum(mask, 1) - 1)
        dest = torch.where(mask & (dest < cap), dest + 1 + n, dummy)
        lane = torch.arange(w, dtype=torch.int32, device=dev)
        vals = (e + 2) * 128 + lane
        out.scatter_(0, dest.reshape(-1), vals.reshape(-1))
        base += u
    return out[: 1 + n + cap]


def word_match_commit_compact(cps, tables: DeviceTables, *, cap: int):
    """All buckets, then the compact vector (the counterpart of
    wordpiece_tpu's word_match_commit_compact).  Returns (compact vector,
    emit matrices): the emits stay on the device for the caller's
    full-emit fallback when the total exceeds `cap`."""
    emits = word_match_commit_multi(cps, tables)
    return compact_emits(emits, cap), emits


def decode_compact(fused: np.ndarray, shapes, cap: int):
    """Host side: the compact vector -> per-bucket emit matrices (one per
    (U, W) in `shapes`), or None when the total exceeds `cap` (the caller
    then needs the full emit matrices)."""
    total = int(fused[0])
    if total > cap:
        return None
    n = sum(u for u, _ in shapes)
    counts = fused[1 : 1 + n].astype(np.int64)
    compact = fused[1 + n : 1 + n + total]
    tid = (compact >> 7) - 2
    pos = compact & 127
    unit = np.repeat(np.arange(n, dtype=np.int64), counts)
    cum = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=cum[1:])
    emits = []
    base = 0
    for u, w in shapes:
        lo, hi = cum[base], cum[base + u]
        emit = np.full((u, w), -2, dtype=np.int32)
        emit[unit[lo:hi] - base, pos[lo:hi]] = tid[lo:hi]
        emits.append(emit)
        base += u
    return emits

"""Binding of the hand-written CUDA kernels of the linear engine's match.

csrc/linear_match.cu holds the kernels that replace the XLA program
wordpiece_tpu/ops/linear_match.py::match_from_sa: per text position, the
window-capped longest vocab match read off the suffix array, with no
[max_len, n] matrix.  Each sweep's surviving lengths are a bitset of at
most three 32-bit words a kind, one a rank a thread, and a run of ranks
is summarised by (least edge, sets at its end).  The tiles kernel writes
the inverse map of the text ranks and each tile's summaries and latest
pushes per (kind, length), the carry kernel scans those over the tiles,
and the walk kernel scans each tile's ranks from the carries and writes
(best_id, best_len): KERNEL_LAUNCHES kernels a call and MEMSETS memsets.
They are compiled with nvcc for sm_90a into a library with a plain C
interface at first use (ops/cuda_build.py) and loaded with ctypes;
nothing is compiled at module import.  The public entry point is
ops/linear_match.match_from_sa, which calls `launch` for CUDA tensors and
counts its calls.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from .cuda_build import BUILD_DIR, CSRC_DIR, build_library, operand

SOURCE = os.path.join(CSRC_DIR, "linear_match.cu")
LIBRARY = os.path.join(BUILD_DIR, "liblinear_match.so")
KERNEL_LAUNCHES = 3  # kernels a call launches: tiles, carry, walk
MEMSETS = 0  # memsets a call: the inverse map covers every rank
TILE = 512  # kTile of csrc/linear_match.cu: ranks a block
MAX_LEN = 96  # kMaxLen, the engine's MAX_SLOT_LEN: the longest max_len the kernels take

_LOCK = threading.Lock()
_LIB = None
build_log = ""  # nvcc's output of the last build (ptxas -v: regs, smem, spills)

_P = ctypes.c_void_p


def bind(lib):
    """Declare the C interface of a build of csrc/linear_match.cu on the
    ctypes library `lib`; returns it."""
    lib.wp_linear_match_scratch_bytes.restype = ctypes.c_longlong
    lib.wp_linear_match_scratch_bytes.argtypes = [ctypes.c_longlong, ctypes.c_int]
    fn = lib.wp_linear_match
    fn.restype = ctypes.c_int
    fn.argtypes = [
        _P,  # rank int32[n_s]
        _P,  # lcp int32[n_s]
        _P,  # who_len int32[n_s]
        _P,  # who_id int32[n_s]
        _P,  # who_kind int32[n_s]
        _P,  # window int32[n_text]
        _P,  # wp bool[n_text]
        ctypes.c_longlong,  # n_s
        ctypes.c_longlong,  # n_text
        ctypes.c_int,  # max_len
        _P,  # scratch
        _P,  # best_id int32[n_text]
        _P,  # best_len int32[n_text]
        _P,  # cudaStream_t
    ]
    return lib


def build(*, force: bool = False):
    """Compile csrc/linear_match.cu (if the library is stale or `force`)
    and load it.  Returns the ctypes library; raises if nvcc fails."""
    global _LIB, build_log
    with _LOCK:
        if _LIB is not None and not force:
            return _LIB
        lib, log = build_library(SOURCE, LIBRARY, force=force)
        if log is not None:
            build_log = log
        _LIB = bind(lib)
        return _LIB


def launch(rank, lcp, who_len, who_id, who_kind, window, wp, *, max_len: int, lib=None):
    """One call (KERNEL_LAUNCHES kernels) on the current stream of the
    tensors' card.  Returns (best_id, best_len) int32[n_text] on the card.
    Takes rank as a permutation of 0..n_s-1 (as the sort and the suffix
    array give it), n_text <= n_s and 1 <= max_len <= MAX_LEN; raises on
    other shapes and on a refused launch.  `lib`, a library passed through
    `bind`, replaces this source's build (to time another version of the
    kernels on the same inputs)."""
    n_s, n_text = int(rank.shape[0]), int(window.shape[0])
    if not 1 <= max_len <= MAX_LEN:
        raise ValueError(f"max_len {max_len} outside 1..{MAX_LEN}")
    if n_s < 1 or n_text > n_s:
        raise ValueError(f"n_text {n_text} and n_s {n_s}: the kernels need 0 <= n_text <= n_s")
    dev = rank.device
    ops = [
        operand("rank", rank, torch.int32, n_s),
        operand("lcp", lcp, torch.int32, n_s),
        operand("who_len", who_len, torch.int32, n_s),
        operand("who_id", who_id, torch.int32, n_s),
        operand("who_kind", who_kind, torch.int32, n_s),
        operand("window", window, torch.int32, n_text),
        operand("wp", wp, torch.bool, n_text),
    ]
    best_id = torch.empty(n_text, dtype=torch.int32, device=dev)
    best_len = torch.empty(n_text, dtype=torch.int32, device=dev)
    lib = lib or build()
    with torch.cuda.device(dev):  # the C side launches on the current device
        scratch = torch.empty(lib.wp_linear_match_scratch_bytes(n_s, int(max_len)),
                              dtype=torch.uint8, device=dev)
        rc = lib.wp_linear_match(
            *(t.data_ptr() for t in ops), n_s, n_text, int(max_len), scratch.data_ptr(),
            best_id.data_ptr(), best_len.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"linear match kernels launch failed: CUDA error {rc}")
    return best_id, best_len

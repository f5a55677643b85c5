"""Binding of the hand-written CUDA kernel of the fast-stream engine's probe.

csrc/match_fast.cu holds match_positions_kernel, which replaces the XLA
program wordpiece_tpu/ops/match_fast.py::match_positions.  It is compiled
with nvcc for sm_90a into a library with a plain C interface at first use
(ops/cuda_build.py) and loaded with ctypes; nothing is compiled at module
import.  The public entry point is ops/match_fast.match_positions, which
calls `launch` for CUDA tensors and counts its launches.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from .cuda_build import BUILD_DIR, CSRC_DIR, build_library

SOURCE = os.path.join(CSRC_DIR, "match_fast.cu")
LIBRARY = os.path.join(BUILD_DIR, "libmatch_fast.so")

_LOCK = threading.Lock()
_LIB = None
build_log = ""  # nvcc's output of the last build (ptxas -v: regs, smem, spills)

_P = ctypes.c_void_p


def build(*, force: bool = False):
    """Compile csrc/match_fast.cu (if the library is missing, older than the
    source, or `force`) and load it.  Returns the ctypes library; raises if
    nvcc fails."""
    global _LIB, build_log
    with _LOCK:
        if _LIB is not None and not force:
            return _LIB
        lib, log = build_library(SOURCE, LIBRARY, force=force)
        if log is not None:
            build_log = log
        fn = lib.wp_match_positions
        fn.restype = ctypes.c_int
        fn.argtypes = [
            _P,  # cp_pad int32[n + max_len]
            _P,  # window int32[n]
            _P,  # wp bool[n]
            _P,  # tags uint8[S]
            _P,  # slots int32[S, 8]
            ctypes.c_longlong,  # n
            ctypes.c_int,  # max_len
            ctypes.c_int,  # max_probe
            ctypes.c_int,  # log2_size
            ctypes.c_uint,  # mult1
            ctypes.c_uint,  # mult2
            _P,  # best_id int32[n]
            _P,  # best_len int32[n]
            ctypes.c_int,  # force the global-tag layout
            ctypes.POINTER(ctypes.c_int),  # out: the layout launched (0 shared, 1 global, -1 none)
            _P,  # cudaStream_t
        ]
        _LIB = lib
        return lib


def _check(name, t, dtype, shape):
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous {dtype}{list(shape)}, got {t.dtype}{list(t.shape)}"
        )


def launch(cp_pad, window, wp, table, *, max_len, max_probe, log2_size, mult1, mult2,
           global_tags=False):
    """One launch of the kernel on the current stream of the tensors'
    device; `table` is an ops.match_fast.ProbeTable, whose tags and slots
    the kernel reads.  Returns (best_id, best_len, mode): mode 0 (tags
    staged in shared memory), 1 (tags read from global memory: the table
    is too large for shared memory, or `global_tags`), or -1 when n == 0
    and nothing ran.  Raises on tensors the kernel does not take and on a
    refused launch."""
    n = int(window.shape[0])
    dev = table.tags.device
    _check("window", window, torch.int32, (n,))
    _check("wp", wp, torch.bool, (n,))
    _check("cp_pad", cp_pad, torch.int32, (n + max_len,))
    if not 4 <= log2_size <= 30:
        raise ValueError(f"log2_size {log2_size} outside the kernel's 4..30")
    size = 1 << log2_size
    _check("tags", table.tags, torch.uint8, (size,))
    _check("slots", table.slots, torch.int32, (size, 8))
    if table.tags.data_ptr() % 16 or table.slots.data_ptr() % 32:
        raise ValueError("tags must be 16-byte and slots 32-byte aligned")
    if max_len < 0 or max_probe < 0:
        raise ValueError(f"max_len {max_len}, max_probe {max_probe}")
    best_id = torch.empty(n, dtype=torch.int32, device=dev)
    best_len = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return best_id, best_len, -1
    lib = build()
    mode = ctypes.c_int(-1)
    with torch.cuda.device(dev):  # the C side launches on the current device
        rc = lib.wp_match_positions(
            cp_pad.data_ptr(),
            window.data_ptr(),
            wp.data_ptr(),
            table.tags.data_ptr(),
            table.slots.data_ptr(),
            n,
            max_len,
            max_probe,
            log2_size,
            mult1 & 0xFFFFFFFF,
            mult2 & 0xFFFFFFFF,
            best_id.data_ptr(),
            best_len.data_ptr(),
            int(global_tags),
            ctypes.byref(mode),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"match_positions kernel launch failed: CUDA error {rc}")
    return best_id, best_len, mode.value

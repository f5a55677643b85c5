"""Binding of the hand-written CUDA kernels of the greedy commit.

csrc/commit.cu holds the kernels that replace the XLA program
wordpiece_tpu/ops/commit.py::commit_with_positions: the walk (one block a
tile: the orbits of F inside the tile by pointer doubling in shared
memory, one integer carried between tiles through the carry chain of
csrc/scan.cuh, visited and failed bits out), the emit (each segment's
kill from the bits and the neighbouring tiles' bytes, then a forward scan
with decoupled look-back for the slots and the compacted writes) and the
fill of the tail: KERNEL_LAUNCHES kernels a call, run to the fixed point
whatever the longest unit, as the plain version and the JAX package do.
They are compiled with nvcc for sm_90a into a library with a plain C
interface at first use (ops/cuda_build.py) and loaded with ctypes;
nothing is compiled at module import.  The public entry point is
ops/commit.commit_with_positions, which calls `launch` for CUDA tensors
and counts its calls.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from .cuda_build import BUILD_DIR, CSRC_DIR, build_library, operand

SOURCE = os.path.join(CSRC_DIR, "commit.cu")
LIBRARY = os.path.join(BUILD_DIR, "libcommit.so")
KERNEL_LAUNCHES = 3  # kernels a call launches (walk, emit, fill), after one memset

_LOCK = threading.Lock()
_LIB = None
build_log = ""  # nvcc's output of the last build (ptxas -v: regs, smem, spills)

_P = ctypes.c_void_p


def build(*, force: bool = False):
    """Compile csrc/commit.cu (if the library is stale or `force`) and load
    it.  Returns the ctypes library; raises if nvcc fails."""
    global _LIB, build_log
    with _LOCK:
        if _LIB is not None and not force:
            return _LIB
        lib, log = build_library(SOURCE, LIBRARY, force=force)
        if log is not None:
            build_log = log
        lib.wp_commit_scratch_bytes.restype = ctypes.c_longlong
        lib.wp_commit_scratch_bytes.argtypes = [ctypes.c_longlong]
        fn = lib.wp_commit
        fn.restype = ctypes.c_int
        fn.argtypes = [
            _P,  # best_id int32[n]
            _P,  # best_len int32[n]
            _P,  # window int32[n]
            _P,  # ss int32[n + 1]
            _P,  # wnext int32[n + 1]
            _P,  # space bool[n]
            _P,  # wp bool[n]
            ctypes.c_longlong,  # n
            ctypes.c_longlong,  # n_valid
            ctypes.c_int,  # unk_id
            _P,  # scratch
            _P,  # ids int32[n]
            _P,  # positions int32[n]
            _P,  # count int32[]
            _P,  # cudaStream_t
        ]
        _LIB = lib
        return lib


def launch(best_id, best_len, feats, n_valid: int, *, unk_id: int):
    """One call (KERNEL_LAUNCHES kernels) on the current stream of the
    tensors' card.  Returns (ids int32[n], positions int32[n], count int32
    0-d), all on the card.  Raises on a refused launch."""
    n = int(best_id.shape[0])
    dev = best_id.device
    ops = [
        operand("best_id", best_id, torch.int32, n),
        operand("best_len", best_len, torch.int32, n),
        operand("window", feats.window, torch.int32, n),
        operand("ss", feats.ss, torch.int32, n + 1),
        operand("wnext", feats.wnext, torch.int32, n + 1),
        operand("space", feats.space, torch.bool, n),
        operand("wp", feats.wp, torch.bool, n),
    ]
    ids = torch.empty(n, dtype=torch.int32, device=dev)
    positions = torch.empty(n, dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    lib = build()
    with torch.cuda.device(dev):  # the C side launches on the current device
        scratch = torch.empty(lib.wp_commit_scratch_bytes(n), dtype=torch.uint8, device=dev)
        rc = lib.wp_commit(
            *(t.data_ptr() for t in ops), n, int(n_valid), int(unk_id), scratch.data_ptr(),
            ids.data_ptr(), positions.data_ptr(), count.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"commit kernels launch failed: CUDA error {rc}")
    return ids, positions, count

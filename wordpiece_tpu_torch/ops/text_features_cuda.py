"""Binding of the hand-written CUDA kernel of the per-position text features.

csrc/text_features.cu holds text_features_kernel, which replaces the XLA
program wordpiece_tpu/ops/text_features.py::compute_features: one reverse
scan with decoupled look-back (csrc/scan.cuh) over 4,096-position tiles
staged through shared memory, that writes every feature in one pass.  It
is compiled with nvcc for sm_90a into a library with a plain C interface
at first use (ops/cuda_build.py) and loaded with ctypes; nothing is
compiled at module import.  The public entry point is
ops/text_features.compute_features, which calls `launch` for CUDA tensors
and counts its launches.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from .cuda_build import BUILD_DIR, CSRC_DIR, aligned16, build_library

SOURCE = os.path.join(CSRC_DIR, "text_features.cu")
LIBRARY = os.path.join(BUILD_DIR, "libtext_features.so")

_LOCK = threading.Lock()
_LIB = None
build_log = ""  # nvcc's output of the last build (ptxas -v: regs, smem, spills)

_P = ctypes.c_void_p


def build(*, force: bool = False):
    """Compile csrc/text_features.cu (if the library is stale or `force`)
    and load it.  Returns the ctypes library; raises if nvcc fails."""
    global _LIB, build_log
    with _LOCK:
        if _LIB is not None and not force:
            return _LIB
        lib, log = build_library(SOURCE, LIBRARY, force=force)
        if log is not None:
            build_log = log
        lib.wp_text_features_scratch_bytes.restype = ctypes.c_longlong
        lib.wp_text_features_scratch_bytes.argtypes = [ctypes.c_longlong]
        fn = lib.wp_text_features
        fn.restype = ctypes.c_int
        fn.argtypes = [
            _P,  # cp int32[n]
            ctypes.c_longlong,  # n
            ctypes.c_longlong,  # n_valid
            ctypes.c_int,  # max_len
            _P,  # scratch (zeroed by the call)
            _P,  # space bool[n]
            _P,  # punct bool[n]
            _P,  # spacing bool[n]
            _P,  # wp bool[n]
            _P,  # window int32[n]
            _P,  # ss int32[n + 1]
            _P,  # wnext int32[n + 1]
            _P,  # cudaStream_t
        ]
        _LIB = lib
        return lib


def launch(cp: torch.Tensor, n_valid: int, max_len: int) -> dict:
    """One launch on the current stream of cp's card.  cp: contiguous
    int32[n] on a CUDA device.  Returns the features as a dict of tensors
    (space, punct, spacing, wp bool[n]; window int32[n]; ss, wnext
    int32[n + 1]).  Raises on a refused launch."""
    n = int(cp.shape[0])
    dev = cp.device
    cp = aligned16(cp)
    out = {name: torch.empty(n, dtype=torch.bool, device=dev)
           for name in ("space", "punct", "spacing", "wp")}
    out["window"] = torch.empty(n, dtype=torch.int32, device=dev)
    out["ss"] = torch.empty(n + 1, dtype=torch.int32, device=dev)
    out["wnext"] = torch.empty(n + 1, dtype=torch.int32, device=dev)
    lib = build()
    with torch.cuda.device(dev):  # the C side launches on the current device
        nbytes = lib.wp_text_features_scratch_bytes(n)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        rc = lib.wp_text_features(
            cp.data_ptr(), n, int(n_valid), int(max_len), scratch.data_ptr(),
            *(out[k].data_ptr() for k in ("space", "punct", "spacing", "wp", "window", "ss",
                                          "wnext")),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"text_features kernel launch failed: CUDA error {rc}")
    return out

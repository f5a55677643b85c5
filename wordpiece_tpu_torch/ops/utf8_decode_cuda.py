"""Binding of the hand-written CUDA kernels of the UTF-8 decode on the card.

csrc/utf8_decode.cu holds utf8_count_kernel (each 4,096-byte tile counts
the bytes that lead a valid sequence; a forward sum scan with decoupled
look-back over the tiles) and utf8_write_kernel (each tile writes its
codepoints from its prefix, and the blocks past the last tile zero the
bucket's padding).  It replaces no TPU kernel: the JAX engine decodes on
the host.  It is compiled with nvcc for sm_90a into a library with a plain
C interface at first use (ops/cuda_build.py) and loaded with ctypes;
nothing is compiled at module import.  The public entry points are
ops/utf8_decode.count_codepoints and write_codepoints, which call `count`
and `write` for CUDA tensors and count their launches; `count` also hands
the host the tiles' prefixes the count kernel computes, on request, and
can leave the read of its total to the caller.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from .cuda_build import BUILD_DIR, CSRC_DIR, build_library

SOURCE = os.path.join(CSRC_DIR, "utf8_decode.cu")
LIBRARY = os.path.join(BUILD_DIR, "libutf8_decode.so")

_LOCK = threading.Lock()
_LIB = None
build_log = ""  # nvcc's output of the last build (ptxas -v: regs, smem, spills)

STATUS_PREFIX = 2  # wp::kStatusPrefix of csrc/scan.cuh: a status word's inclusive prefix

_P = ctypes.c_void_p
_LL = ctypes.c_longlong


def build(*, force: bool = False):
    """Compile csrc/utf8_decode.cu (if the library is stale or `force`)
    and load it.  Returns the ctypes library; raises if nvcc fails."""
    global _LIB, build_log
    with _LOCK:
        if _LIB is not None and not force:
            return _LIB
        lib, log = build_library(SOURCE, LIBRARY, force=force)
        if log is not None:
            build_log = log
        lib.wp_utf8_scratch_bytes.restype = _LL
        lib.wp_utf8_scratch_bytes.argtypes = [_LL]
        lib.wp_utf8_count.restype = ctypes.c_int
        lib.wp_utf8_count.argtypes = [
            _P,  # bytes uint8[n], 16-byte aligned
            _LL,  # n
            _P,  # scratch (zeroed by the call)
            _P,  # total: a pinned host int32
            _P,  # cudaStream_t
        ]
        lib.wp_utf8_prefixes.restype = ctypes.c_int
        lib.wp_utf8_prefixes.argtypes = [
            _P,  # scratch, as the count left it
            _LL,  # n
            _P,  # host: pinned int64[tiles]
            _P,  # cudaStream_t
        ]
        lib.wp_utf8_tile_bytes.restype = _LL
        lib.wp_utf8_tile_bytes.argtypes = []
        lib.wp_utf8_write.restype = ctypes.c_int
        lib.wp_utf8_write.argtypes = [
            _P,  # bytes uint8[n], as counted
            _LL,  # n
            _P,  # scratch, as the count left it
            _LL,  # n_out: the codepoints counted
            _LL,  # size
            _P,  # out int32[size]
            _P,  # cudaStream_t
        ]
        _LIB = lib
        return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"utf8 {what} kernel launch failed: CUDA error {rc}")


def count(data: torch.Tensor, *, prefixes: bool = False, wait: bool = True):
    """The count kernel on the current stream of data's card, its total
    copied to a pinned host word on the stream.  data: contiguous, 16-byte
    aligned uint8[n], n > 0.  Returns (the scratch write reads, the pinned
    int32[1] total, tiles).  With `wait` the stream is synchronised here,
    so the copy that brought `data` to the card is done too and the total
    can be read; without, the caller reads it after a later
    synchronisation.  With `prefixes` (which waits) the same read brings
    each tile's inclusive prefix, and tiles is (the bytes a tile of the
    kernel, int64[ceil(n / tile)]: the codepoints up to the end of each
    tile); else None."""
    n = int(data.shape[0])
    dev = data.device
    lib = build()
    with torch.cuda.device(dev):  # the C side launches on the current device
        scratch = torch.empty(lib.wp_utf8_scratch_bytes(n), dtype=torch.uint8, device=dev)
        total = torch.empty(1, dtype=torch.int32, pin_memory=True)
        stream = torch.cuda.current_stream(dev)
        _check(lib.wp_utf8_count(data.data_ptr(), n, scratch.data_ptr(), total.data_ptr(),
                                 stream.cuda_stream), "count")
        if not (wait or prefixes):
            return scratch, total, None
        words = None
        if prefixes:
            tile = int(lib.wp_utf8_tile_bytes())  # the stride of the prefixes, the kernel's own
            words = torch.empty(-(-n // tile), dtype=torch.int64, pin_memory=True)
            _check(lib.wp_utf8_prefixes(scratch.data_ptr(), n, words.data_ptr(),
                                        stream.cuda_stream), "prefixes")
        stream.synchronize()
    if words is None:
        return scratch, total, None
    # A status word: its state in the high half, its value in the low.
    w = words.numpy()
    if not (w >> 32 == STATUS_PREFIX).all():
        raise RuntimeError("utf8 count: a tile's status word holds no inclusive prefix")
    return scratch, total, (tile, w & 0xFFFFFFFF)


def write(data: torch.Tensor, scratch: torch.Tensor, n_out: int, size: int) -> torch.Tensor:
    """The write kernel on the current stream of data's card: int32[size],
    the n_out codepoints `count` found in data, then zeros."""
    dev = data.device
    out = torch.empty(size, dtype=torch.int32, device=dev)
    lib = build()
    with torch.cuda.device(dev):
        _check(lib.wp_utf8_write(data.data_ptr(), int(data.shape[0]), scratch.data_ptr(),
                                 int(n_out), int(size), out.data_ptr(),
                                 torch.cuda.current_stream(dev).cuda_stream), "write")
    return out

"""ctypes bindings for the native host runtime (auto-building, optional).

Falls back to the pure numpy/Python implementations when the shared
library is unavailable (e.g. no compiler); all callers treat this module
as an accelerator, never a semantic change — the native code implements
exactly the same reference semantics and is cross-checked by tests.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.join(os.path.dirname(__file__), "native")
# WORDPIECE_TPU_TORCH_NATIVE_SO overrides the library filename (sanitizer/
# scalar builds: libwordpiece_host_san.so / libwordpiece_host_scalar.so).
# The library is built by `make` into this package's own native/ directory.
_SO = os.path.join(
    _DIR, os.environ.get("WORDPIECE_TPU_TORCH_NATIVE_SO", "libwordpiece_host.so")
)
_SOURCES = (os.path.join(_DIR, "wordpiece_host.cc"), os.path.join(_DIR, "Makefile"))
_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def is_stale(library: str, sources) -> bool:
    """Whether `library` is missing or older than one of `sources` (file
    times, the rule of ops/cuda_build.is_stale)."""
    if not os.path.exists(library):
        return True
    built = os.path.getmtime(library)
    return any(os.path.getmtime(p) > built for p in sources)


def ensure_built(directory: str, library: str, sources) -> bool:
    """Run `make <library>` in `directory` when the library is stale;
    returns whether a library is there afterwards.  Where make fails, an
    older library that exists is kept.  Other processes (test workers) may
    build or load at the same moment: an exclusive lock on the directory's
    Makefile serialises the check and the build, and the Makefile links to
    a temporary name and renames it into place, so no process loads a
    half-linked library or loses the one it has mapped."""
    with open(os.path.join(directory, "Makefile")) as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if is_stale(library, sources):
            try:
                subprocess.run(
                    ["make", "-C", directory, "-s", os.path.basename(library)],
                    capture_output=True,
                    timeout=300,
                )
            except (OSError, subprocess.SubprocessError):
                pass  # no make, or a hung build: keep what is there
        return os.path.exists(library)


def _load():
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        try:
            if not ensure_built(_DIR, _SO, _SOURCES):
                return None
            lib = ctypes.CDLL(_SO)
        except OSError:
            _LIB = None
            return None

        lib.wp_decode_utf8.restype = ctypes.c_int64
        lib.wp_decode_utf8.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_void_p,
        ]
        lib.wp_bucket_fill.restype = None
        lib.wp_bucket_fill.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_void_p,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lib.wp_join_units_cps.restype = ctypes.c_int64
        lib.wp_join_units_cps.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_void_p,
        ]
        lib.wp_expand.restype = ctypes.c_int64
        lib.wp_expand.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lib.wp_expand_mt.restype = ctypes.c_int64
        lib.wp_expand_mt.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int32,
        ]
        lib.wp_expand_total.restype = ctypes.c_int64
        lib.wp_expand_total.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_void_p,
        ]
        lib.wp_verify_emit.restype = ctypes.c_int64
        lib.wp_verify_emit.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.c_void_p,
        ]
        lib.wp_encode_units_with.restype = ctypes.c_int64
        lib.wp_encode_units_with.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lib.wp_dedupe_session_new.restype = ctypes.c_void_p
        lib.wp_dedupe_session_new.argtypes = []
        lib.wp_dedupe_session_free.restype = None
        lib.wp_dedupe_session_free.argtypes = [ctypes.c_void_p]
        lib.wp_dedupe_session_segment.restype = ctypes.c_int64
        lib.wp_dedupe_session_segment.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int32,
        ]
        lib.wp_vocab_new.restype = ctypes.c_void_p
        lib.wp_vocab_new.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_int32,
        ]
        lib.wp_vocab_free.restype = None
        lib.wp_vocab_free.argtypes = [ctypes.c_void_p]
        lib.wp_encode_with.restype = ctypes.c_int64
        lib.wp_encode_with.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_void_p,
        ]
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


_N_THREADS_OVERRIDE: int | None = None


def set_n_threads(n: int | None) -> None:
    """Programmatic host-thread override (CLI --n-threads lands here).
    None restores the default policy."""
    global _N_THREADS_OVERRIDE
    _N_THREADS_OVERRIDE = None if n is None else max(1, int(n))


def n_threads() -> int:
    """Host threads for the native segment/dedupe fan-out.

    Priority: set_n_threads() > WORDPIECE_TPU_THREADS env > min(cpus, 2).
    The reference plumbs this through its runner's n_threads argument
    (tests/runner.cpp:23) into the global thread pool; here the native
    splitter currently uses at most 2 (one split point), so values above
    2 are accepted but clamp inside the library."""
    if _N_THREADS_OVERRIDE is not None:
        return _N_THREADS_OVERRIDE
    env = os.environ.get("WORDPIECE_TPU_THREADS")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    return min(os.cpu_count() or 1, 2)


def decode_utf8(data: bytes) -> np.ndarray | None:
    """Native UTF-8 decode; None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(len(data), dtype=np.uint32)
    n = lib.wp_decode_utf8(
        buf.ctypes.data_as(ctypes.c_void_p), len(data), out.ctypes.data_as(ctypes.c_void_p)
    )
    return out[:n].copy()


def pack_vocab(vocab) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vocabulary -> (words_flat u32, offsets i64[v+1], flags u8[v])."""
    flat = np.ascontiguousarray(vocab.flat, dtype=np.uint32)
    offsets = np.ascontiguousarray(vocab.offsets, dtype=np.int64)
    flags = (
        vocab.is_prefix.astype(np.uint8)
        | ((vocab.is_special | vocab.is_malformed).astype(np.uint8) << 1)
    )
    return flat, offsets, flags


def segment_dedupe(data: bytes):
    """Segment corpus bytes into units and dedupe.

    Returns (occ_unique int32[n_occ], uniq_start int64[nu],
    uniq_len int32[nu], uniq_cplen int32[nu]) or None.

    Implemented as a one-shot DedupeSession: a fresh session's first
    segment call has exactly this contract (occ ids in first-seen order,
    new_* = every unique in uid order), and the session scanner carries
    the fast paths (fat self-contained table slots, the single-codepoint
    direct maps, 2-thread halves) that the legacy standalone scanner
    lacks."""
    lib = _load()
    if lib is None:
        return None
    s = DedupeSession()
    try:
        return s.segment(data)
    finally:
        s.close()


class DedupeSession:
    """Cross-chunk dedupe: occurrence ids are global across `segment`
    calls; each call returns only the chunk's first-seen units (in global
    uid order, offsets into that chunk's bytes).  One session per corpus
    encode; not thread-safe (call segment from one thread at a time)."""

    import threading as _threading

    _tls = _threading.local()

    def __init__(self):
        lib = _load()
        if lib is None:
            raise RuntimeError("native host runtime unavailable")
        self._lib = lib
        self._h = lib.wp_dedupe_session_new()
        self.n_total = 0

    @staticmethod
    def _buf(name: str, cap: int, dtype) -> np.ndarray:
        """Thread-local scratch, reused across sessions (sessions are
        per-encode-call; fresh buffers would page-fault every call).
        Safe: segment() is documented single-threaded, and the returned
        arrays are copies."""
        import threading

        tls = DedupeSession._tls
        scr = getattr(tls, "scr", None)
        if scr is None:
            scr = tls.scr = {}
        arr = scr.get(name)
        if arr is None or arr.shape[0] < cap:
            arr = np.empty(int(cap * 1.25) + 16, dtype=dtype)
            scr[name] = arr
        return arr

    def segment(self, data: bytes):
        """-> (occ int32[n_occ] global uids, new_start int64[n_new],
        new_len int32[n_new], new_cplen int32[n_new]).  All four are
        copies (safe to hold across later segment calls)."""
        size = len(data)
        cap = max(size, 1)
        buf = np.frombuffer(data, dtype=np.uint8) if size else np.zeros(1, np.uint8)
        occ = self._buf("occ", cap, np.int32)
        nstart = self._buf("nstart", cap, np.int64)
        nlen = self._buf("nlen", cap, np.int32)
        ncplen = self._buf("ncplen", cap, np.int32)
        n_new = ctypes.c_int64(0)
        n_total = ctypes.c_int64(0)
        nthr = n_threads()
        n_occ = self._lib.wp_dedupe_session_segment(
            self._h,
            buf.ctypes.data_as(ctypes.c_void_p),
            size,
            occ.ctypes.data_as(ctypes.c_void_p),
            nstart.ctypes.data_as(ctypes.c_void_p),
            nlen.ctypes.data_as(ctypes.c_void_p),
            ncplen.ctypes.data_as(ctypes.c_void_p),
            ctypes.byref(n_new),
            ctypes.byref(n_total),
            np.int32(nthr),
        )
        self.n_total = n_total.value
        k = n_new.value
        return (
            occ[:n_occ].copy(),
            nstart[:k].copy(),
            nlen[:k].copy(),
            ncplen[:k].copy(),
        )

    def close(self):
        if self._h is not None:
            self._lib.wp_dedupe_session_free(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


def bucket_fill(data: bytes, ustart, ulen, ucplen, widths):
    """Pack unique units into width-bucketed int32 codepoint matrices.

    Returns (matrices list[int32 (U_b, W_b)], bucket_of, row_of); units
    longer than the widest bucket get bucket_of == len(widths)."""
    lib = _load()
    if lib is None:
        return None
    widths = np.asarray(widths, dtype=np.int32)
    nu = ustart.shape[0]
    counts = np.zeros(widths.shape[0] + 1, dtype=np.int64)
    bucket_pre = np.searchsorted(widths, ucplen, side="left")
    for b in range(widths.shape[0] + 1):
        counts[b] = int(np.count_nonzero(bucket_pre == b))
    matrices = [
        np.full((int(counts[b]), int(widths[b])), 32, dtype=np.int32)
        for b in range(widths.shape[0])
    ]
    ptrs = (ctypes.c_void_p * widths.shape[0])(
        *[m.ctypes.data_as(ctypes.c_void_p).value for m in matrices]
    )
    bucket_of = np.empty(nu, dtype=np.int32)
    row_of = np.empty(nu, dtype=np.int32)
    buf = np.frombuffer(data, dtype=np.uint8) if len(data) else np.zeros(1, np.uint8)
    lib.wp_bucket_fill(
        buf.ctypes.data_as(ctypes.c_void_p),
        np.ascontiguousarray(ustart, np.int64).ctypes.data_as(ctypes.c_void_p),
        np.ascontiguousarray(ulen, np.int32).ctypes.data_as(ctypes.c_void_p),
        np.ascontiguousarray(ucplen, np.int32).ctypes.data_as(ctypes.c_void_p),
        nu,
        widths.ctypes.data_as(ctypes.c_void_p),
        np.int32(widths.shape[0]),
        ptrs,
        bucket_of.ctypes.data_as(ctypes.c_void_p),
        row_of.ctypes.data_as(ctypes.c_void_p),
    )
    return matrices, bucket_of, row_of


def join_units_cps(data: bytes, ustart, ulen, u_begin: int, u_end: int, cap: int):
    """Decode units [u_begin, u_end) into one int32 codepoint array with
    single-space separators (the linear engine's joined-batch layout).
    `cap` = sum(ucplen[u_begin:u_end]) + (u_end - u_begin - 1)."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(max(cap, 1), dtype=np.int32)
    buf = np.frombuffer(data, dtype=np.uint8) if len(data) else np.zeros(1, np.uint8)
    n = lib.wp_join_units_cps(
        buf.ctypes.data_as(ctypes.c_void_p),
        np.ascontiguousarray(ustart, np.int64).ctypes.data_as(ctypes.c_void_p),
        np.ascontiguousarray(ulen, np.int32).ctypes.data_as(ctypes.c_void_p),
        np.int64(u_begin),
        np.int64(u_end),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    assert n <= cap
    return out[:n]


def expand(occ_unique, tok_flat, tok_offsets, *, slack: bool = False) -> np.ndarray | None:
    """slack=True promises tok_flat already has >= 2 readable int32 slots
    past tok_offsets[-1] (wp_expand over-reads 2 ids per occurrence)."""
    lib = _load()
    if lib is None:
        return None
    occ = np.ascontiguousarray(occ_unique, np.int32)
    flat = np.ascontiguousarray(tok_flat, np.int32)
    offs = np.ascontiguousarray(tok_offsets, np.int64)
    if not slack:
        # wp_expand over-copies up to 2 ids per step: give 2 spare reads.
        flat = np.concatenate([flat, np.zeros(2, np.int32)])
    total = int(
        lib.wp_expand_total(
            occ.ctypes.data_as(ctypes.c_void_p),
            occ.shape[0],
            offs.ctypes.data_as(ctypes.c_void_p),
        )
    )
    out = np.empty(total + 2, dtype=np.int32)  # 2 spare write slots
    n = lib.wp_expand_mt(
        occ.ctypes.data_as(ctypes.c_void_p),
        occ.shape[0],
        flat.ctypes.data_as(ctypes.c_void_p),
        offs.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p),
        np.int32(n_threads()),
    )
    assert n == total
    return out[:n]


def verify_emit(mat, emit, vocab, unk_id: int) -> np.ndarray | None:
    """Rows of `emit` whose token ids don't reproduce the unit strings in
    `mat` (hash-collision guard); None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    mat = np.ascontiguousarray(mat, np.int32)
    emit = np.ascontiguousarray(emit, np.int32)
    flat = np.ascontiguousarray(vocab.flat, np.uint32)
    offs = np.ascontiguousarray(vocab.offsets, np.int64)
    bad = np.empty(max(mat.shape[0], 1), dtype=np.int32)
    n = lib.wp_verify_emit(
        mat.ctypes.data_as(ctypes.c_void_p),
        emit.ctypes.data_as(ctypes.c_void_p),
        mat.shape[0],
        mat.shape[1],
        flat.ctypes.data_as(ctypes.c_void_p),
        offs.ctypes.data_as(ctypes.c_void_p),
        vocab.size,
        np.int32(unk_id),
        bad.ctypes.data_as(ctypes.c_void_p),
    )
    return bad[:n].copy()


class VocabHandle:
    """Reusable native scalar encoder (vocab maps built once)."""

    def __init__(self, vocab):
        lib = _load()
        if lib is None:
            raise RuntimeError("native runtime unavailable")
        self._lib = lib
        flat, offsets, flags = pack_vocab(vocab)
        self._keep = (flat, offsets, flags)
        self._h = lib.wp_vocab_new(
            flat.ctypes.data_as(ctypes.c_void_p),
            offsets.ctypes.data_as(ctypes.c_void_p),
            flags.ctypes.data_as(ctypes.c_void_p),
            vocab.size,
            np.int32(vocab.unk_token_id),
        )

    def encode(self, text_cp: np.ndarray) -> np.ndarray:
        cp = np.ascontiguousarray(text_cp, dtype=np.uint32)
        out = np.empty(cp.shape[0] + 1, dtype=np.int32)
        n = self._lib.wp_encode_with(
            self._h,
            cp.ctypes.data_as(ctypes.c_void_p),
            cp.shape[0],
            out.ctypes.data_as(ctypes.c_void_p),
        )
        return out[:n].copy()

    def encode_units(self, data: bytes, starts, lens, cap: int):
        """Encode many byte-span units in one native call.

        -> (flat int32[sum counts], counts int32[n_units]); `cap` must be
        >= the total codepoint length of the units."""
        starts = np.ascontiguousarray(starts, np.int64)
        lens = np.ascontiguousarray(lens, np.int32)
        nu = starts.shape[0]
        buf = np.frombuffer(data, dtype=np.uint8) if len(data) else np.zeros(1, np.uint8)
        flat = np.empty(max(cap, 1) + 1, dtype=np.int32)
        counts = np.empty(max(nu, 1), dtype=np.int32)
        n = self._lib.wp_encode_units_with(
            self._h,
            buf.ctypes.data_as(ctypes.c_void_p),
            starts.ctypes.data_as(ctypes.c_void_p),
            lens.ctypes.data_as(ctypes.c_void_p),
            nu,
            flat.ctypes.data_as(ctypes.c_void_p),
            counts.ctypes.data_as(ctypes.c_void_p),
        )
        return flat[:n], counts[:nu]

    def __del__(self):
        try:
            self._lib.wp_vocab_free(self._h)
        except Exception:
            pass


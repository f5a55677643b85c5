"""Wrappers of the hand-written CUDA kernels of the word engine.

Four kernels live in csrc/word_kernel.cu:
  - the match+commit kernel, which replaces the TPU kernel
    wordpiece_tpu/ops/word_kernel_pallas.py::_kernel: one launch per
    dispatch covers every bucket (word_match_commit_multi);
  - the compaction kernel, which replaces the XLA epilogue of the JAX
    package's word_match_commit_compact (compact_from_counts);
  - the same function split in two for a vocabulary partitioned over
    ranks (parallel/word_sharding.py): the match kernel, every position's
    longest hit against a table or partition (word_match_packed, replacing
    the XLA program wordpiece_tpu/ops/word_kernel.py::word_match), and the
    commit kernel, the walk, rollback and emit from given matches
    (word_commit_packed, replacing ::word_commit).  Between them travels
    one packed int32 match per position (ops/word_kernel.pack_matches);
    word_match_multi and word_commit_multi are the same kernels with the
    (best_id, best_len) pairs of the JAX functions at their edges.
They are compiled with nvcc for sm_90a into one library with a plain C
interface, at first use, into this package's build/ directory (ignored by
git; ops/cuda_build.py), and loaded with ctypes.  Nothing here is compiled
or imported from CUDA at module import.

Each wrapper takes its kernel's plain version only for tensors that lie
on the CPU (ops/word_kernel.py for the match, compact_emits for the
compaction).  For a CUDA tensor it launches the kernel on the current
stream of the tensors' card, made the current device around the launch,
or raises; it never falls back.  Counts of launches:
`word_match_commit_multi.launches` (all launches; one per dispatch),
`word_match_commit_multi.launches_global` (those that read the slot
image, the list offsets and key fingerprints, from global memory instead
of staging it in shared memory), `compact_from_counts.launches`,
`word_match_packed.launches` (and `.launches_global`) and
`word_commit_packed.launches`.

Layouts:
  - a bucket is a narrow unit matrix uint8/uint16/int32[U, W] (W = the
    bucket width, contiguous); columns >= W read as space; the buckets of
    one dispatch may differ in dtype;
  - the emit matrix is int32[U, W]: a token id per emitting position,
    -2 elsewhere;
  - a bucket's matches are (best_id, best_len) int32[U, W]: the longest
    in-window hit of every position, -1 and 0 where nothing hits; packed,
    one int32[U, W], (best_len << 24) | best_id and 0 where nothing hits
    (the split kernels take widths <= 127);
  - the compact vector (word_match_commit_compact) is int32[1 + U_total
    + cap]: the total id count, the per-unit counts of every bucket in
    order, then (token_id + 2) * 128 + position for every emitted id in
    (bucket, unit, position) order, capped at `cap` entries.  Entries
    past min(total, cap) are undefined.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch

from ..core.length_tables import DeviceTables
from .cuda_build import BUILD_DIR, CSRC_DIR, build_library
from .word_kernel import (
    MAX_PACKED_WIDTH, pack_matches, unpack_matches, word_commit, word_match, word_match_commit,
)

SOURCE = os.path.join(CSRC_DIR, "word_kernel.cu")
LIBRARY = os.path.join(BUILD_DIR, "libword_kernel.so")
MAX_BUCKETS = 8  # kMaxBuckets of the kernel's bucket descriptor

_LOCK = threading.Lock()
_LIB = None
build_log = ""  # nvcc's output of the last build (ptxas -v: regs, smem, spills)

_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_PI = ctypes.POINTER(ctypes.c_int)
_PLL = ctypes.POINTER(ctypes.c_longlong)


def build(*, force: bool = False):
    """Compile csrc/word_kernel.cu (if the library is missing, older than
    the source, or `force`) and load it.  Returns the ctypes library;
    raises if nvcc fails."""
    global _LIB, build_log
    with _LOCK:
        if _LIB is not None and not force:
            return _LIB
        lib, log = build_library(SOURCE, LIBRARY, force=force)
        if log is not None:
            build_log = log
        fn = lib.wp_word_match_commit
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_int,  # n_buckets
            _PP,  # unit matrices
            _PI,  # bytes per codepoint, per bucket
            _PLL,  # units, per bucket
            _PI,  # widths
            _PP,  # emit matrices int32[U, W]
            _P,  # slot image int32[image words]: offsets, fingerprints
            ctypes.c_int,  # off_words
            ctypes.c_int,  # image words
            _P,  # slot keys int32[slots, 4] {k1, k2, tid, 0}
            _P,  # lane_salts uint32[max_len + 1]
            ctypes.c_int,  # max_len
            ctypes.c_uint,  # mult1
            ctypes.c_uint,  # mult2
            ctypes.c_int,  # unk_id
            _P,  # per-unit counts int32[U_total]
            ctypes.c_int,  # force the global-key layout
            _PI,  # out: the layout launched (0 shared, 1 global, -1 none)
            _P,  # cudaStream_t
        ]
        fn = lib.wp_word_match
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_int,  # n_buckets
            _PP,  # unit matrices
            _PI,  # bytes per codepoint, per bucket
            _PLL,  # units, per bucket
            _PI,  # widths
            _PP,  # packed match matrices int32[U, W]
            _P,  # slot image
            ctypes.c_int,  # off_words
            ctypes.c_int,  # image words
            _P,  # slot keys
            _P,  # lane_salts
            ctypes.c_int,  # max_len
            ctypes.c_uint,  # mult1
            ctypes.c_uint,  # mult2
            ctypes.c_int,  # force the global-key layout
            _PI,  # out: the layout launched (0 shared, 1 global, -1 none)
            _P,  # cudaStream_t
        ]
        fn = lib.wp_word_commit
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_int,  # n_buckets
            _PP,  # unit matrices
            _PI,  # bytes per codepoint, per bucket
            _PLL,  # units, per bucket
            _PI,  # widths
            _PP,  # packed match matrices int32[U, W] (the combined matches)
            _PP,  # emit matrices int32[U, W]
            ctypes.c_int,  # max_len
            ctypes.c_int,  # unk_id
            _P,  # per-unit counts int32[U_total]
            _PI,  # out: -1 when nothing was launched
            _P,  # cudaStream_t
        ]
        fn = lib.wp_compact_emits
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_int,  # n_buckets
            _PP,  # emit matrices
            _PLL,  # units
            _PI,  # widths
            _P,  # the compact vector int32[1 + U_total + cap]
            ctypes.c_int,  # cap
            _P,  # chunk sums, int32[scratch]: this call's scratch
            ctypes.c_int,  # scratch
            _P,  # cudaStream_t
        ]
        _LIB = lib
        return lib


_CP_DTYPES = (torch.uint8, torch.uint16, torch.int32)


def _arrays(ctype, values):
    return (ctype * len(values))(*values)


def word_match_commit_multi(
    cps, tables: DeviceTables, *, counts: torch.Tensor | None = None,
    global_keys: bool = False,
) -> list[torch.Tensor]:
    """Every bucket's emit matrix int32[U, W], in ONE kernel launch on the
    card.  `counts` (int32[sum of U], optional) receives each unit's emit
    count, buckets in order.  `global_keys` forces the kernel to read the
    slot image from global memory even where it fits in shared memory
    (the smoke test holds that layout against the plain version);
    otherwise the layout is chosen by size."""
    cps = list(cps)
    for cp in cps:
        if cp.dim() != 2:
            raise ValueError(f"unit matrix must be 2-D, got shape {tuple(cp.shape)}")
        if cp.device != tables.packed.device:
            raise ValueError(f"tables on {tables.packed.device}, units on {cp.device}")
    dev = tables.packed.device
    if dev.type == "cpu":
        emits = [
            word_match_commit(
                cp, tables.k1, tables.k2, tables.tid, width=int(cp.shape[1]),
                **tables.statics,
            )
            for cp in cps
        ]
        _fill_counts(counts, emits)
        return emits
    units, widths = _check_units(cps, dev)
    outs = [torch.empty((u, w), dtype=torch.int32, device=dev) for u, w in zip(units, widths)]
    counts = _counts_for(counts, sum(units), dev)
    if sum(units) == 0:
        return outs
    lib = build()
    mode = ctypes.c_int(-1)
    with torch.cuda.device(dev):  # the C side launches on the current device
        rc = lib.wp_word_match_commit(
            *_unit_args(cps, units, widths),
            _arrays(ctypes.c_void_p, [o.data_ptr() for o in outs]),
            tables.slot_image.data_ptr(),
            tables.off_words,
            int(tables.slot_image.shape[0]),
            tables.slot_keys.data_ptr(),
            tables.lane_salts_t.data_ptr(),
            tables.max_len,
            tables.mult1 & 0xFFFFFFFF,
            tables.mult2 & 0xFFFFFFFF,
            tables.unk_id,
            counts.data_ptr(),
            int(global_keys),
            ctypes.byref(mode),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"word_match_commit kernel launch failed: CUDA error {rc}")
    if mode.value >= 0:  # -1: every bucket was empty, nothing launched
        word_match_commit_multi.launches += 1
        if mode.value == 1:
            word_match_commit_multi.launches_global += 1
    return outs


word_match_commit_multi.launches = 0
word_match_commit_multi.launches_global = 0


def _check_units(cps, dev) -> tuple[list[int], list[int]]:
    """Raises on unit matrices the kernels do not take; returns their
    units and widths."""
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not 1 <= len(cps) <= MAX_BUCKETS:
        raise ValueError(f"{len(cps)} buckets: the kernel takes 1..{MAX_BUCKETS}")
    for cp in cps:
        if cp.dtype not in _CP_DTYPES:
            raise TypeError(f"unit matrix dtype {cp.dtype} not in {_CP_DTYPES}")
        if not cp.is_contiguous():
            raise ValueError("unit matrix must be contiguous")
        if not 1 <= cp.shape[1] <= 255:
            raise ValueError(f"width {cp.shape[1]} outside the kernel's 1..255")
    return [int(cp.shape[0]) for cp in cps], [int(cp.shape[1]) for cp in cps]


def _counts_for(counts, n: int, dev) -> torch.Tensor:
    if counts is None:
        return torch.empty(n, dtype=torch.int32, device=dev)
    if counts.shape != (n,) or counts.dtype != torch.int32 or counts.device != dev:
        raise ValueError(f"counts must be int32[{n}] on {dev}")
    return counts


def _unit_args(cps, units, widths) -> tuple:
    """The C entry points' first five arguments: the buckets' unit matrices."""
    return (
        len(cps),
        _arrays(ctypes.c_void_p, [cp.data_ptr() for cp in cps]),
        _arrays(ctypes.c_int, [cp.element_size() for cp in cps]),
        _arrays(ctypes.c_longlong, units),
        _arrays(ctypes.c_int, widths),
    )


def _fill_counts(counts, emits) -> None:
    if counts is not None and emits:
        counts.copy_(torch.cat([(e != -2).sum(dim=1, dtype=torch.int32) for e in emits]))


def _check_split(cps, dev) -> tuple[list[int], list[int]]:
    units, widths = _check_units(cps, dev)
    if max(widths) > MAX_PACKED_WIDTH:
        raise ValueError(f"width {max(widths)}: a packed match takes widths <= {MAX_PACKED_WIDTH}")
    return units, widths


def _flat_views(flat: torch.Tensor, cps) -> list[torch.Tensor]:
    """The buckets' [U, W] matrices, back to back in `flat`."""
    out, off = [], 0
    for cp in cps:
        k = cp.shape[0] * cp.shape[1]
        out.append(flat[off : off + k].view(cp.shape))
        off += k
    return out


def word_match_packed(
    cps, tables: DeviceTables, *, out: torch.Tensor | None = None, global_keys: bool = False
) -> list[torch.Tensor]:
    """Every bucket's packed matches int32[U, W] (ops/word_kernel.
    pack_matches: the longest in-window hit of every position against
    `tables`, the whole table or one partition of parallel/word_sharding.
    shard_word_tables), in ONE kernel launch on the card.  `out`
    (int32[sum of U * W], optional) receives the buckets' matrices back to
    back, and the returned matrices are views of it.  `global_keys` as for
    word_match_commit_multi."""
    cps = list(cps)
    dev = tables.packed.device
    for cp in cps:
        if cp.dim() != 2 or cp.device != dev:
            raise ValueError(f"unit matrices must be 2-D on {dev}")
    n_cells = sum(int(cp.shape[0]) * int(cp.shape[1]) for cp in cps)
    if out is None:
        out = torch.empty(n_cells, dtype=torch.int32, device=dev)
    elif out.shape != (n_cells,) or out.dtype != torch.int32 or out.device != dev:
        raise ValueError(f"out must be int32[{n_cells}] on {dev}")
    mats = _flat_views(out, cps)
    if dev.type == "cpu":
        kw = {k: v for k, v in tables.statics.items() if k != "unk_id"}
        for cp, m in zip(cps, mats):
            w = int(cp.shape[1])
            m.copy_(pack_matches(*word_match(cp, tables.k1, tables.k2, tables.tid, width=w, **kw), w))
        return mats
    units, widths = _check_split(cps, dev)
    if n_cells == 0:
        return mats
    lib = build()
    mode = ctypes.c_int(-1)
    with torch.cuda.device(dev):  # the C side launches on the current device
        rc = lib.wp_word_match(
            *_unit_args(cps, units, widths),
            _arrays(ctypes.c_void_p, [m.data_ptr() for m in mats]),
            tables.slot_image.data_ptr(),
            tables.off_words,
            int(tables.slot_image.shape[0]),
            tables.slot_keys.data_ptr(),
            tables.lane_salts_t.data_ptr(),
            tables.max_len,
            tables.mult1 & 0xFFFFFFFF,
            tables.mult2 & 0xFFFFFFFF,
            int(global_keys),
            ctypes.byref(mode),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"word_match kernel launch failed: CUDA error {rc}")
    if mode.value >= 0:
        word_match_packed.launches += 1
        if mode.value == 1:
            word_match_packed.launches_global += 1
    return mats


word_match_packed.launches = 0
word_match_packed.launches_global = 0

def word_commit_packed(
    cps, packed, *, max_len: int, unk_id: int, counts: torch.Tensor | None = None
) -> list[torch.Tensor]:
    """Every bucket's emit matrix int32[U, W] from its packed matches
    int32[U, W] (typically the max-combined matches of every vocab
    partition), in ONE kernel launch on the card: the greedy walk, the
    whole-word UNK rollback and the emit.  `max_len` and `unk_id` are the
    tables' statics; `counts` as for word_match_commit_multi."""
    cps = list(cps)
    packed = list(packed)
    if len(packed) != len(cps):
        raise ValueError(f"{len(packed)} match matrices for {len(cps)} buckets")
    dev = cps[0].device if cps else torch.device("cpu")
    for cp, m in zip(cps, packed):
        if cp.dim() != 2 or m.shape != cp.shape:
            raise ValueError("matches must have their unit matrix's [U, W] shape")
        if m.device != cp.device or cp.device != dev:
            raise ValueError(f"unit matrices and matches must all be on {dev}")
    if dev.type == "cpu":
        emits = []
        for cp, m in zip(cps, packed):
            w = int(cp.shape[1])
            emits.append(word_commit(cp, *unpack_matches(m), width=w, max_len=max_len, unk_id=unk_id))
        _fill_counts(counts, emits)
        return emits
    units, widths = _check_split(cps, dev)
    for m in packed:
        if m.dtype != torch.int32 or not m.is_contiguous():
            raise ValueError("packed matches must be contiguous int32")
    outs = [torch.empty((u, w), dtype=torch.int32, device=dev) for u, w in zip(units, widths)]
    counts = _counts_for(counts, sum(units), dev)
    if sum(units) == 0:
        return outs
    lib = build()
    mode = ctypes.c_int(-1)
    with torch.cuda.device(dev):  # the C side launches on the current device
        rc = lib.wp_word_commit(
            *_unit_args(cps, units, widths),
            _arrays(ctypes.c_void_p, [m.data_ptr() for m in packed]),
            _arrays(ctypes.c_void_p, [o.data_ptr() for o in outs]),
            max_len,
            unk_id,
            counts.data_ptr(),
            ctypes.byref(mode),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"word_commit kernel launch failed: CUDA error {rc}")
    if mode.value >= 0:
        word_commit_packed.launches += 1
    return outs


word_commit_packed.launches = 0


def word_match_multi(cps, tables: DeviceTables, *, global_keys: bool = False) -> list[tuple]:
    """word_match_packed with the JAX word_match's outputs: every bucket's
    (best_id, best_len), each int32[U, W], -1 and 0 where nothing hits."""
    return [unpack_matches(m) for m in word_match_packed(cps, tables, global_keys=global_keys)]


def word_commit_multi(
    cps, matches, *, max_len: int, unk_id: int, counts: torch.Tensor | None = None
) -> list[torch.Tensor]:
    """word_commit_packed on the JAX word_commit's inputs: every bucket's
    matches (best_id, best_len), each [U, W], ids in [0, 2^24) where
    best_len > 0."""
    cps = list(cps)
    matches = list(matches)
    if len(matches) != len(cps):
        raise ValueError(f"{len(matches)} match pairs for {len(cps)} buckets")
    packed = []
    for cp, (bid, blen) in zip(cps, matches):
        if cp.dim() != 2 or bid.shape != cp.shape or blen.shape != cp.shape:
            raise ValueError("matches must have their unit matrix's [U, W] shape")
        packed.append(pack_matches(bid, blen, int(cp.shape[1])))
    return word_commit_packed(cps, packed, max_len=max_len, unk_id=unk_id, counts=counts)


def compact_emits(emits, cap: int) -> torch.Tensor:
    """The compaction's plain version: emit matrices -> the compact vector
    (module docstring), with torch ops on the emits' device and no host
    synchronisation."""
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
        _check_position_field(w)
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


def _check_position_field(w: int) -> None:
    if w > 128:
        raise ValueError(f"width {w}: positions must fit the 7-bit field")


COMPACT_CHUNK = 64  # units of one chunk of the compaction kernel (kChunkUnits)


def compact_from_counts(emits, fused: torch.Tensor, cap: int) -> torch.Tensor:
    """The compaction kernel: `fused` is the compact vector int32[1 + n +
    cap] whose counts segment fused[1 : 1 + n] already holds each unit's
    emit count (the match kernel writes it).  One cooperative launch sums
    the counts of each chunk, crosses one grid-wide barrier, then writes
    fused[0] (the total) and the capped entries.  Returns `fused`."""
    emits = list(emits)
    units = [int(e.shape[0]) for e in emits]
    widths = [int(e.shape[1]) for e in emits]
    n = sum(units)
    if fused.dim() != 1 or fused.shape[0] != 1 + n + cap or fused.dtype != torch.int32:
        raise ValueError(f"compact vector must be int32[{1 + n + cap}]")
    for w in widths:
        _check_position_field(w)
    for e in emits:  # the kernel's contract, held on the CPU too
        if e.device != fused.device or e.dtype != torch.int32 or not e.is_contiguous():
            raise ValueError("emit matrices must be contiguous int32 on the vector's device")
    if fused.device.type == "cpu":
        fused.copy_(compact_emits(emits, cap))
        return fused
    if fused.device.type != "cuda":
        raise ValueError(f"unsupported device {fused.device}")
    if not 1 <= len(emits) <= MAX_BUCKETS:
        raise ValueError(f"{len(emits)} buckets: the kernel takes 1..{MAX_BUCKETS}")
    if fused.data_ptr() % 16:
        raise ValueError("the compact vector must be 16-byte aligned")
    # Scratch of this call alone, a sum per chunk: two calls on two
    # streams share nothing.
    chunks = max(1, sum(-(-u // COMPACT_CHUNK) for u in units))
    chunk_sums = torch.empty(chunks, dtype=torch.int32, device=fused.device)
    lib = build()
    with torch.cuda.device(fused.device):  # the C side launches on the current device
        rc = lib.wp_compact_emits(
            len(emits),
            _arrays(ctypes.c_void_p, [e.data_ptr() for e in emits]),
            _arrays(ctypes.c_longlong, units),
            _arrays(ctypes.c_int, widths),
            fused.data_ptr(),
            cap,
            chunk_sums.data_ptr(),
            chunks,
            torch.cuda.current_stream(fused.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"compaction kernel launch failed: CUDA error {rc}")
    compact_from_counts.launches += 1
    return fused


compact_from_counts.launches = 0


def word_match_commit_compact(
    cps, tables: DeviceTables, *, cap: int, global_keys: bool = False
):
    """All buckets, then the compact vector (the counterpart of
    wordpiece_tpu's word_match_commit_compact): on the card one
    match+commit launch that also writes the per-unit counts, then one
    compaction launch.  Returns (compact vector, emit matrices): the
    emits stay on the device for the caller's full-emit fallback when the
    total exceeds `cap`."""
    cps = list(cps)
    if tables.packed.device.type == "cpu":
        emits = word_match_commit_multi(cps, tables)
        return compact_emits(emits, cap), emits
    n = sum(int(cp.shape[0]) for cp in cps)
    fused = torch.empty(1 + n + cap, dtype=torch.int32, device=tables.packed.device)
    emits = word_match_commit_multi(
        cps, tables, counts=fused[1 : 1 + n], global_keys=global_keys
    )
    return compact_from_counts(emits, fused, cap), emits


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

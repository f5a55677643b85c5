"""Per-length lane-bucketed match tables for the word-centric engine.

The TPU's fast data-dependent access primitive is the 128-lane crossbar
(`take_along_axis` along the minor axis), so the vocabulary index is laid
out as, for each token length l, a (B_l, 128) grid: lane = 7 hash bits,
rows = the tokens sharing that lane (padded with empty slots, id == -1).
A position probing length l computes its two rolling hashes, derives its
lane, and compares against the B_l candidates of that lane — B_l
broadcast-compare steps, each touching 128 distinct tokens per step
across the vector unit.  Σ_l B_l ≈ vocab/128 (+ skew), the scheme's cost
per position.

Host-side guarantees (mirrors core/vocab.py's index): no two distinct
active tokens share (h1, h2, len, kind) — checked exactly, multipliers
re-drawn on a real 64-bit collision — so probes can never miss; false
hits against non-vocab text are ~2^-64 (fold of both 32-bit hashes, the
length and the prefix/suffix kind).  The lane salt is searched to
minimize bucket skew (B_l is a max, not an average).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .vocab import Vocabulary, hash_all, _DEFAULT_MULTIPLIERS

LANES = 128
LEN_MIX = 0x9E3779B1
KIND_MIX = 0x85EBCA77
MAX_TOKEN_ID = 1 << 24


@dataclasses.dataclass
class LengthTables:
    # Stacked over lengths: rows[l] occupy rows_off[l] : rows_off[l+1].
    k1: np.ndarray  # int32[R, 128] (uint32 bits)
    k2: np.ndarray  # int32[R, 128] (uint32 bits, len/kind folded)
    tid: np.ndarray  # int32[R, 128], -1 empty
    rows_off: list[int]  # len max_len+2 (python ints, static)
    mult1: int
    mult2: int
    lane_salts: tuple  # per-length salts, index 0 unused (static)
    max_len: int
    unk_token_id: int


@dataclasses.dataclass
class DeviceTables:
    """LengthTables in the port's device form.

    ``packed`` interleaves the three tables as int32[R, 128, 4] = {k1, k2,
    tid, 0}; ``k1``/``k2``/``tid`` are int32[R, 128] views of it for the
    plain version.

    The CUDA kernel probes the slot layout of pack_slots instead: the
    occupied slots of every (length, lane) in row order, one list after
    another.  ``slot_image`` is int32[off_words + fingerprint words]: the
    (max_len + 1) * 128 + 1 list offsets (``slot_off``), zero-padded to
    ``off_words`` (a multiple of 4), then every slot's 16-bit k1
    fingerprint (``slot_fp``), zero-padded to a multiple of 8 slots, so
    the kernel stages both with one bulk copy of 16-byte multiples and
    reads 8 fingerprints per 16-byte load.  ``slot_keys`` is
    int32[max(n_slots, 1), 4] = {k1, k2, tid, 0}, read on a fingerprint
    hit (``slot_k1``/``slot_k2``/``slot_tid`` are its columns).
    ``lane_salts_t`` holds the uint32 salts' bits as int32[max_len + 1].
    The remaining fields are the host-side statics both versions take."""

    packed: torch.Tensor
    slot_image: torch.Tensor
    slot_keys: torch.Tensor
    lane_salts_t: torch.Tensor
    off_words: int
    n_slots: int
    rows_off: tuple
    mult1: int
    mult2: int
    lane_salts: tuple
    max_len: int
    unk_id: int

    @property
    def k1(self) -> torch.Tensor:
        return self.packed[..., 0]

    @property
    def k2(self) -> torch.Tensor:
        return self.packed[..., 1]

    @property
    def tid(self) -> torch.Tensor:
        return self.packed[..., 2]

    @property
    def slot_off(self) -> torch.Tensor:
        return self.slot_image[: (self.max_len + 1) * LANES + 1]

    @property
    def slot_fp(self) -> torch.Tensor:
        """The fingerprints' uint16 bits as int16[n_slots]."""
        return self.slot_image[self.off_words :].view(torch.int16)[: self.n_slots]

    @property
    def slot_k1(self) -> torch.Tensor:
        return self.slot_keys[: self.n_slots, 0]

    @property
    def slot_k2(self) -> torch.Tensor:
        return self.slot_keys[: self.n_slots, 1]

    @property
    def slot_tid(self) -> torch.Tensor:
        return self.slot_keys[: self.n_slots, 2]

    @property
    def statics(self) -> dict:
        """Keyword arguments of ops.word_kernel.word_match_commit."""
        return dict(
            max_len=self.max_len,
            rows_off=self.rows_off,
            mult1=self.mult1,
            mult2=self.mult2,
            lane_salts=self.lane_salts,
            unk_id=self.unk_id,
        )


def pack_slots(k1, k2, tid, rows_off, max_len: int):
    """The occupied slots (tid >= 0) of every (length, lane), in row order,
    packed one list after another in (length, lane) order.  Built from the
    k1/k2/tid arrays alone, so either package's tables give the same
    layout.  Returns (slot_off int64[(max_len + 1) * 128 + 1], k1, k2, tid
    int32[n_slots]): list (l, lane) is slots slot_off[l * 128 + lane] :
    slot_off[l * 128 + lane + 1].  Only empty slots are dropped, and they
    never hit, so a scan of a list in order finds the hits of the row scan
    in the same order (the last one wins in both)."""
    k1 = np.asarray(k1).view(np.int32)
    k2 = np.asarray(k2).view(np.int32)
    tid = np.asarray(tid, dtype=np.int32)
    sizes = np.zeros((max_len + 1, LANES), dtype=np.int64)
    parts = []
    for l in range(1, max_len + 1):
        r0, r1 = int(rows_off[l]), int(rows_off[l + 1])
        if r1 == r0:
            continue
        # Lane-major, rows ascending within a lane.
        lane, row = np.nonzero(tid[r0:r1].T >= 0)
        rows = r0 + row
        parts.append((k1[rows, lane], k2[rows, lane], tid[rows, lane]))
        sizes[l] = np.bincount(lane, minlength=LANES)
    slot_off = np.zeros(sizes.size + 1, dtype=np.int64)
    np.cumsum(sizes.reshape(-1), out=slot_off[1:])
    if parts:
        sk1, sk2, stid = (np.concatenate(p) for p in zip(*parts))
    else:
        sk1 = sk2 = stid = np.zeros(0, dtype=np.int32)
    return slot_off, sk1, sk2, stid


def fingerprint(k1) -> np.ndarray:
    """16-bit fingerprint of k1 keys (their uint32 bits): the two halves
    folded by xor.  The kernel compares it before the full keys."""
    k = np.asarray(k1).astype(np.int64) & 0xFFFFFFFF
    return ((k ^ (k >> 16)) & 0xFFFF).astype(np.uint16)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def load_length_tables(tables, device) -> DeviceTables:
    """Carry length tables onto `device`.  `tables` is any object with the
    LengthTables fields as numpy arrays and Python ints (this module's
    LengthTables or the JAX package's).  Raises on a token id >= 2^24."""
    device = torch.device(device)
    k1 = np.ascontiguousarray(np.asarray(tables.k1).view(np.int32))
    k2 = np.ascontiguousarray(np.asarray(tables.k2).view(np.int32))
    tid = np.ascontiguousarray(np.asarray(tables.tid, dtype=np.int32))
    if tid.size and int(tid.max()) >= MAX_TOKEN_ID:
        # A packed match (ops/word_kernel.pack_matches) holds an id in 24 bits.
        raise ValueError(f"token id {int(tid.max())}: ids must be < 2^24")
    packed = np.zeros(k1.shape + (4,), dtype=np.int32)
    packed[..., 0] = k1
    packed[..., 1] = k2
    packed[..., 2] = tid
    salts = np.asarray(
        [int(s) & 0xFFFFFFFF for s in tables.lane_salts], dtype=np.uint32
    ).view(np.int32)
    rows_off = tuple(int(r) for r in tables.rows_off)
    max_len = int(tables.max_len)

    slot_off, sk1, sk2, stid = pack_slots(k1, k2, tid, rows_off, max_len)
    n_slots = int(sk1.shape[0])
    off_words = _round_up(slot_off.shape[0], 4)
    image = np.zeros(off_words + _round_up(n_slots, 8) // 2, dtype=np.int32)
    image[: slot_off.shape[0]] = slot_off
    image[off_words:].view(np.uint16)[:n_slots] = fingerprint(sk1)
    keys = np.zeros((max(n_slots, 1), 4), dtype=np.int32)
    keys[:n_slots, 0] = sk1
    keys[:n_slots, 1] = sk2
    keys[:n_slots, 2] = stid

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return DeviceTables(
        packed=dev(packed),
        slot_image=dev(image),
        slot_keys=dev(keys),
        lane_salts_t=dev(salts),
        off_words=off_words,
        n_slots=n_slots,
        rows_off=rows_off,
        mult1=int(tables.mult1),
        mult2=int(tables.mult2),
        lane_salts=tuple(int(s) for s in tables.lane_salts),
        max_len=max_len,
        unk_id=int(tables.unk_token_id),
    )


def fold_key2(h2: np.ndarray, length, kind) -> np.ndarray:
    """Second 32-bit key with length and kind folded in."""
    with np.errstate(over="ignore"):
        return (
            h2.astype(np.uint32)
            ^ (np.uint32(LEN_MIX) * np.asarray(length, np.uint32))
            ^ (np.uint32(KIND_MIX) * np.asarray(kind, np.uint32))
        )


def lane_of(h1: np.ndarray, h2: np.ndarray, length, kind, salt: int) -> np.ndarray:
    with np.errstate(over="ignore"):
        mixed = (
            h1.astype(np.uint32)
            ^ (h2.astype(np.uint32) << np.uint32(1))
            ^ (np.asarray(length, np.uint32) * np.uint32(LEN_MIX))
            ^ (np.asarray(kind, np.uint32) * np.uint32(KIND_MIX))
        ) * np.uint32(salt | 1)
        return (mixed >> np.uint32(32 - 7)).astype(np.int32)


def build_length_tables(vocab: Vocabulary, *, max_salt_tries: int = 8) -> LengthTables:
    rng = np.random.default_rng(12345)
    m1, m2 = _DEFAULT_MULTIPLIERS
    for _attempt in range(16):
        h1, h2 = hash_all(vocab, m1, m2)
        lens = vocab.lengths.astype(np.int64)
        kinds = vocab.is_prefix.astype(np.uint32)
        active = np.nonzero(vocab.active)[0]
        # Exact intra-vocab collision check on (h1, h2, len, kind).
        seen: dict[tuple, int] = {}
        collision = False
        for i in active:
            key = (int(h1[i]), int(h2[i]), int(lens[i]), int(kinds[i]))
            j = seen.get(key)
            if j is not None and not (
                lens[i] == lens[j]
                and np.array_equal(vocab.word(i), vocab.word(j))
            ):
                collision = True
                break
            seen[key] = i
        if not collision:
            break
        m1 = int(rng.integers(1, 1 << 32)) | 1
        m2 = int(rng.integers(1, 1 << 32)) | 1
    else:  # pragma: no cover
        raise RuntimeError("could not find collision-free hash multipliers")

    max_len = vocab.max_len
    # Per-length lane salt search: each length's buckets are balanced
    # independently (B_l is a max over lanes, so skew directly costs
    # probe rows).
    salts = [1] * (max_len + 1)
    for l in range(1, max_len + 1):
        sel = active[(lens[active] == l)]
        if not sel.size:
            continue
        best = None
        for _try in range(max_salt_tries):
            salt = int(rng.integers(1, 1 << 32)) | 1
            lanes_l = lane_of(h1[sel], h2[sel], lens[sel], kinds[sel], salt)
            b_l = int(np.bincount(lanes_l, minlength=LANES).max())
            if best is None or b_l < best[1]:
                best = (salt, b_l)
        salts[l] = best[0]

    k2f = fold_key2(h2, lens, kinds)

    rows_off = [0, 0]  # lengths are 1-based; rows_off[l] .. rows_off[l+1]
    k1_rows, k2_rows, id_rows = [], [], []
    lanes = np.zeros(vocab.size, dtype=np.int32)
    for l in range(1, max_len + 1):
        sel = active[(lens[active] == l)]
        if sel.size:
            lanes[sel] = lane_of(h1[sel], h2[sel], lens[sel], kinds[sel], salts[l])
        counts = np.bincount(lanes[sel], minlength=LANES) if sel.size else np.zeros(
            LANES, np.int64
        )
        b_l = int(counts.max()) if sel.size else 0
        kk1 = np.zeros((b_l, LANES), dtype=np.uint32)
        kk2 = np.zeros((b_l, LANES), dtype=np.uint32)
        tid = np.full((b_l, LANES), -1, dtype=np.int32)
        slot = np.zeros(LANES, dtype=np.int64)
        for i in sel:
            ln = lanes[i]
            r = slot[ln]
            # Duplicate (string, kind) entries: last id wins, matching the
            # reference's map overwrite (src/fast.cpp:33-35).
            dup = None
            for rr in range(r):
                if kk1[rr, ln] == h1[i] and kk2[rr, ln] == k2f[i] and tid[rr, ln] >= 0:
                    dup = rr
                    break
            if dup is not None:
                tid[dup, ln] = np.int32(i)
                continue
            kk1[r, ln] = h1[i]
            kk2[r, ln] = k2f[i]
            tid[r, ln] = np.int32(i)
            slot[ln] = r + 1
        k1_rows.append(kk1)
        k2_rows.append(kk2)
        id_rows.append(tid)
        rows_off.append(rows_off[-1] + b_l)

    if rows_off[-1] == 0:
        k1 = np.zeros((1, LANES), dtype=np.uint32)
        k2 = np.zeros((1, LANES), dtype=np.uint32)
        tid = np.full((1, LANES), -1, dtype=np.int32)
    else:
        k1 = np.concatenate([r for r in k1_rows if r.shape[0]], axis=0)
        k2 = np.concatenate([r for r in k2_rows if r.shape[0]], axis=0)
        tid = np.concatenate([r for r in id_rows if r.shape[0]], axis=0)

    return LengthTables(
        k1=k1.view(np.int32),
        k2=k2.view(np.int32),
        tid=tid,
        rows_off=rows_off,
        mult1=m1,
        mult2=m2,
        lane_salts=tuple(salts),
        max_len=max_len,
        unk_token_id=vocab.unk_token_id,
    )

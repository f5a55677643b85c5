"""Vocabulary model: parsing, token classification, packed device arrays.

Mirrors the reference's vocabulary semantics (src/utils.cpp:81-146):
 - one token per line; the id is the 0-based line index;
 - a token starting with "##" is a *suffix* (continuation) token and the
   "##" is stripped from its match string;
 - "[x...]" with total length > 2 is a *special* token;
 - a token is *malformed* if it contains invalid unicode or if it consists
   solely of punctuation/space codepoints and is longer than one codepoint;
 - the UNK id is the line index of the literal "[UNK]" line, else -1;
 - special and malformed tokens never participate in matching
   (src/fast.cpp:28-30, src/linear.cpp:179);
 - an empty match string raises (src/utils.cpp:100).

On top of the semantic model this module builds the *device index*: a
replicated open-addressing hash table over (token string, table kind) that
the TPU match kernels probe, plus a packed (vocab, max_len) codepoint
matrix used for exact match verification.  The hash is a pair of 32-bit
polynomial rolling hashes (mod 2^32); the host build proves there are no
intra-vocabulary key collisions (rebuilding with fresh multipliers if any),
so device probes can never produce a false miss; false hits against
non-vocab text are eliminated by the post-commit verification pass.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from . import unicode as uni


@dataclasses.dataclass
class Vocabulary:
    """Host-side vocabulary model (analogue of WordPieceVocabulary).

    Token match strings (with the ## marker stripped) are stored flat:
    token i spans flat[offsets[i]:offsets[i+1]].
    """

    flat: np.ndarray  # uint32, concatenated match strings
    offsets: np.ndarray  # int64[v+1]
    is_prefix: np.ndarray  # bool[v]
    is_special: np.ndarray  # bool[v]
    is_malformed: np.ndarray  # bool[v]
    unk_token_id: int = -1

    @property
    def size(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    @property
    def words(self) -> list[np.ndarray]:
        """Ragged view of the match strings (kept for convenience)."""
        return [
            self.flat[self.offsets[i] : self.offsets[i + 1]] for i in range(self.size)
        ]

    def word(self, i: int) -> np.ndarray:
        return self.flat[self.offsets[i] : self.offsets[i + 1]]

    @property
    def active(self) -> np.ndarray:
        """Tokens that participate in matching."""
        return ~(self.is_special | self.is_malformed)

    @property
    def max_len(self) -> int:
        """Longest active token, in codepoints (src/fast.cpp:26-31)."""
        lens = self.lengths[self.active]
        return int(lens.max()) if lens.size else 0

    def padded(self, width: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        """(int32[v, width] codepoints padded with -1, int32[v] lengths)."""
        lens = self.lengths.astype(np.int64)
        width = int(width if width is not None else max(int(lens.max(initial=0)), 1))
        col = np.arange(width, dtype=np.int64)[None, :]
        idx = self.offsets[:-1, None] + col
        mask = col < lens[:, None]
        out = np.where(mask, self.flat[np.minimum(idx, max(self.flat.shape[0] - 1, 0))], np.uint32(0))
        return np.where(mask, out, -1).astype(np.int32), lens.astype(np.int32)


def parse_vocab(lines: Sequence[str | bytes]) -> Vocabulary:
    """Parse vocabulary lines (parseVocab, src/utils.cpp:108-121).

    Fully vectorized: lines are joined with '\\n' (codepoint 10 can never
    be produced by invalid-byte dropping, so it is a safe separator),
    decoded once, and classified with array ops over the flat stream.
    """
    raws = [l.encode("utf-8") if isinstance(l, str) else bytes(l) for l in lines]
    v = len(raws)
    if v == 0:
        return Vocabulary(
            flat=np.zeros(0, np.uint32),
            offsets=np.zeros(1, np.int64),
            is_prefix=np.zeros(0, bool),
            is_special=np.zeros(0, bool),
            is_malformed=np.zeros(0, bool),
        )
    joined = b"\n".join(raws)
    cps = uni.decode_utf8(joined).astype(np.uint32)

    nl = np.nonzero(cps == 10)[0]
    starts = np.concatenate([[0], nl + 1])
    ends = np.concatenate([nl, [cps.shape[0]]])
    if starts.shape[0] != v:  # pragma: no cover - separator is injective
        raise ValueError("vocab line splitting failed")
    lens = ends - starts

    # Invalid-byte detection: a line is malformed when re-encoding its
    # decoded codepoints yields fewer bytes than the raw line had
    # (invalid bytes were dropped) — mirrors INVALID_UNICODE marking at
    # src/utils.cpp:92-94.
    enc_len = (
        np.ones(cps.shape[0], dtype=np.int64)
        + (cps >= 0x80)
        + (cps >= 0x800)
        + (cps >= 0x10000)
    )
    ecum = np.concatenate([[0], np.cumsum(enc_len)])
    enc_lens = ecum[ends] - ecum[starts]
    raw_lens = np.asarray([len(r) for r in raws], dtype=np.int64)
    has_invalid = enc_lens != raw_lens

    cps_safe = np.concatenate([cps, np.zeros(2, np.uint32)])  # safe sentinel reads
    first = cps_safe[np.minimum(starts, cps.shape[0])]
    second = cps_safe[np.minimum(starts + 1, cps.shape[0] + 1)]
    last = cps_safe[np.maximum(ends - 1, 0)]
    is_suffix = (lens >= 2) & (first == uni.SHARP_SIGN) & (second == uni.SHARP_SIGN)
    is_special = ~is_suffix & (lens > 2) & (first == ord("[")) & (last == ord("]"))

    woff = starts + 2 * is_suffix
    wlen = lens - 2 * is_suffix
    if (wlen == 0).any():
        raise ValueError("Vocab word is empty")

    punctish = (uni.is_punctuation(cps) | uni.is_space(cps)).astype(np.int64)
    pcum = np.concatenate([[0], np.cumsum(punctish)])
    all_punct = (pcum[woff + wlen] - pcum[woff]) == wlen
    is_malformed = has_invalid | (all_punct & (wlen > 1))

    # Flat match strings with separators removed and ## stripped.
    keep = np.ones(cps.shape[0], dtype=bool)
    keep[nl] = False
    for k in (0, 1):
        keep[np.minimum(starts[is_suffix] + k, cps.shape[0] - 1)] = False
    flat = cps[keep]
    offsets = np.zeros(v + 1, dtype=np.int64)
    np.cumsum(wlen, out=offsets[1:])

    unk_matches = np.nonzero([r == b"[UNK]" for r in raws])[0]
    unk_token_id = int(unk_matches[-1]) if unk_matches.size else -1

    # Duplicate vocab lines are OUT OF CONTRACT: the reference's own
    # validity guard rejects them (tests/tests.cpp:29-33), its fast
    # algorithm binds the LAST duplicate (map assignment,
    # src/fast.cpp:34) while its linear binding is SA-order-dependent —
    # so engines may legally emit different ids for duplicated strings.
    # Warn loudly rather than guessing.
    if len(set(raws)) != len(raws):  # pragma: no cover - invalid input
        import sys

        dupes = len(raws) - len(set(raws))
        print(
            f"wordpiece_tpu: vocabulary has {dupes} duplicate line(s); "
            "duplicate entries are rejected by the reference's validity "
            "guard and engines may bind either id for them",
            file=sys.stderr,
        )

    return Vocabulary(
        flat=flat,
        offsets=offsets,
        is_prefix=~is_suffix,
        is_special=is_special,
        is_malformed=is_malformed,
        unk_token_id=unk_token_id,
    )


def read_vocab_file(path: str) -> Vocabulary:
    """readVocabFromFile (src/utils.cpp:123-137): one token per line."""
    with open(path, "rb") as f:
        data = f.read()
    # std::getline splits on '\n' and never yields a trailing empty line.
    lines = data.split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    return parse_vocab(lines)


# ---------------------------------------------------------------------------
# Device index: replicated open-addressing hash table + packed strings.
# ---------------------------------------------------------------------------

_DEFAULT_MULTIPLIERS = (0x01000193, 0x0085EBCA)  # odd 32-bit multipliers


@dataclasses.dataclass
class VocabIndex:
    """Replicated device-side match index (all arrays are host numpy;
    callers device_put them, replicated across the mesh)."""

    # Open-addressing table, linear probing. Empty slots have id == -1.
    table_k1: np.ndarray  # uint32[S]
    table_k2: np.ndarray  # uint32[S]
    table_meta: np.ndarray  # int32[S]: (len << 1) | is_prefix  for the slot
    table_id: np.ndarray  # int32[S]
    # Packed token strings for exact verification: int32[v, max_len], -1 pad.
    packed: np.ndarray
    packed_len: np.ndarray  # int32[v] (0 for inactive tokens)
    mult1: int
    mult2: int
    max_len: int
    max_probe: int  # longest probe chain (host-computed, exact bound)
    unk_token_id: int
    log2_size: int

    @property
    def size(self) -> int:
        return self.table_id.shape[0]


def _hash_pair(word: np.ndarray, m1: int, m2: int) -> tuple[int, int]:
    h1 = np.uint32(0)
    h2 = np.uint32(0)
    mm1 = np.uint32(m1)
    mm2 = np.uint32(m2)
    with np.errstate(over="ignore"):
        for c in word.astype(np.uint32):
            h1 = np.uint32(h1 * mm1 + c)
            h2 = np.uint32(h2 * mm2 + c)
    return int(h1), int(h2)


def hash_all(vocab: Vocabulary, m1: int, m2: int) -> tuple[np.ndarray, np.ndarray]:
    """Rolling hashes of every token's match string, vectorized over the
    padded (v, max_len) matrix; equals _hash_pair per token."""
    padded, lens = vocab.padded()
    h1 = np.zeros(vocab.size, dtype=np.uint32)
    h2 = np.zeros(vocab.size, dtype=np.uint32)
    mm1 = np.uint32(m1)
    mm2 = np.uint32(m2)
    with np.errstate(over="ignore"):
        for j in range(padded.shape[1]):
            c = padded[:, j].astype(np.uint32)
            upd = j < lens
            h1 = np.where(upd, h1 * mm1 + c, h1)
            h2 = np.where(upd, h2 * mm2 + c, h2)
    return h1, h2


def build_index(vocab: Vocabulary, *, min_table_size: int = 1 << 10) -> VocabIndex:
    """Build the replicated probe table.

    Guarantees: no two active vocab entries share (k1, k2, len, kind); the
    probe chain bound `max_probe` is exact.  If a full 64-bit key collision
    between *distinct* strings occurs (astronomically unlikely), the build
    retries with fresh multipliers.
    """
    active_ids = np.nonzero(vocab.active)[0]
    n_active = active_ids.shape[0]
    size = max(min_table_size, 1)
    while size < 4 * max(n_active, 1):
        size *= 2
    log2_size = int(size).bit_length() - 1

    rng = np.random.default_rng(0)
    m1, m2 = _DEFAULT_MULTIPLIERS
    for _attempt in range(16):
        ok, built = _try_build(vocab, active_ids, size, m1, m2)
        if ok:
            k1, k2, meta, ids, max_probe = built
            break
        m1 = int(rng.integers(1, 1 << 32)) | 1
        m2 = int(rng.integers(1, 1 << 32)) | 1
    else:  # pragma: no cover - 16 collisions in a row is impossible
        raise RuntimeError("could not build a collision-free vocab index")

    max_len = vocab.max_len
    padded, plens = vocab.padded(width=max(max_len, 1))
    active_mask = vocab.active
    packed = np.where(active_mask[:, None], padded[:, : max(max_len, 1)], -1)
    packed_len = np.where(active_mask, plens, 0).astype(np.int32)

    return VocabIndex(
        table_k1=k1,
        table_k2=k2,
        table_meta=meta,
        table_id=ids,
        packed=packed,
        packed_len=packed_len,
        mult1=m1,
        mult2=m2,
        max_len=max_len,
        max_probe=max_probe,
        unk_token_id=vocab.unk_token_id,
        log2_size=log2_size,
    )


def _try_build(vocab, active_ids, size, m1, m2):
    mask = size - 1
    k1 = np.zeros(size, dtype=np.uint32)
    k2 = np.zeros(size, dtype=np.uint32)
    meta = np.full(size, -1, dtype=np.int32)
    ids = np.full(size, -1, dtype=np.int32)
    max_probe = 1
    ah1, ah2 = hash_all(vocab, m1, m2)
    lens = vocab.lengths
    seen: dict[tuple[int, int, int, int], int] = {}
    for i in active_ids:
        h1 = int(ah1[i])
        h2 = int(ah2[i])
        wl = int(lens[i])
        kind = int(vocab.is_prefix[i])
        key = (h1, h2, wl, kind)
        prev = seen.get(key)
        if prev is not None:
            other = vocab.word(prev)
            w = vocab.word(i)
            if other.shape[0] != w.shape[0] or not np.array_equal(other, w):
                return False, None  # true 64-bit collision: rehash
            # Duplicate string+kind: the reference's fast path overwrites,
            # last id wins (src/fast.cpp:33-35).
        seen[key] = i
        m = np.int32((wl << 1) | kind)
        bucket = _bucket(h1, h2, kind, wl, mask)
        probes = 1
        while ids[bucket] >= 0:
            if (
                int(k1[bucket]) == h1
                and int(k2[bucket]) == h2
                and int(meta[bucket]) == int(m)
            ):
                break  # duplicate entry: overwrite below
            bucket = (bucket + 1) & mask
            probes += 1
        k1[bucket] = h1
        k2[bucket] = h2
        meta[bucket] = m
        ids[bucket] = i
        max_probe = max(max_probe, probes)
    return True, (k1, k2, meta, ids, max_probe)


def _bucket(h1: int, h2: int, kind: int, length: int, mask: int) -> int:
    log2 = (mask + 1).bit_length() - 1
    mixed = (h1 ^ ((h2 << 1) & 0xFFFFFFFF) ^ (length * 0x9E3779B1) ^ (kind * 0x85EBCA77)) & 0xFFFFFFFF
    # Fibonacci mixing to spread low-entropy hashes across buckets.
    return ((mixed * 0x9E3779B1) & 0xFFFFFFFF) >> (32 - log2)


def bucket_of(h1, h2, kind, length, mask: int, xp=np):
    """Array version of `_bucket` usable in numpy and jax.numpy."""
    h1 = h1.astype(xp.uint32)
    h2 = h2.astype(xp.uint32)
    mixed = h1 ^ (h2 << xp.uint32(1)) ^ (length.astype(xp.uint32) * xp.uint32(0x9E3779B1)) ^ (
        kind.astype(xp.uint32) * xp.uint32(0x85EBCA77)
    )
    log2 = int(mask + 1).bit_length() - 1
    return ((mixed * xp.uint32(0x9E3779B1)) >> xp.uint32(32 - log2)).astype(xp.int32) & xp.int32(
        mask
    )

"""Fast-stream encoder: a document as cap-sized programs on the device.

The counterpart of wordpiece_tpu/engine.py.  Pipeline, on the encoder's
device:
  codepoints -> text features -> per-position longest match -> greedy
  commit -> compacted ids.

Inputs are padded to a bucket size (powers of two between 2^7 and 2^22,
then multiples of 2^22), as the JAX engine pads them for its compiled
programs, so both engines see the same shapes.  On a CUDA device each step
is a hand-written kernel: the features csrc/text_features.cu
(ops/text_features.py), the match csrc/match_fast.cu (ops/match_fast.py)
and the commit csrc/commit.cu (ops/commit.py), one call of each a piece.
On device="cpu" the same wrappers run their plain PyTorch versions;
nothing falls back from one to the other.

Pieces.  A document of at most LADDER_CAP (2^22, the ladder's cap)
codepoints runs as one piece: the whole text as one program, in one
bucket.  A longer one runs as a sequence of pieces of at most LADDER_CAP
codepoints each, one after another, each in its own bucket, so the card
holds one cap-sized bucket's arrays at a time, whatever the document's
length.  A piece ends just before a space-class codepoint (ASCII 9-13 and
32, U+2581: core/unicode.find_space_cut's class), which no token crosses,
so the ids are those of the whole text.  The cuts look back from where the
cap falls within a budget that keeps the count of pieces within
ceil(n / cap) + 1 (`_plan`); where no space-class codepoint lies within
it, the rest of the document runs as one piece, in a bucket past the cap.
The host reads each piece's id count; that read waits for the piece, and
the next piece's copy and count are enqueued before it, so it also brings
their count.  The ids of each piece but the last then go by DMA into one
pinned host buffer the calling thread keeps; the last piece's go to the
call's result as a one-piece call's do (a copy to pageable memory), and
those in the buffer are copied in front of them on the host.

`encode_bytes` decodes the UTF-8 on the device: the bytes go to the card
through one pinned staging buffer the encoder keeps (grown to the largest
call), the decode's first pass counts the codepoints (csrc/utf8_decode.cu,
ops/utf8_decode.py; the host reads the count to size the bucket) and its
second writes them into the padded bucket.  For a document of more
bytes than the cap the same read brings the count's prefix a tile, from
which the host cuts the bytes (`byte_pieces`); the first piece is written
from the document's count, each later one is copied from the staging
buffer and counted on its own, and its count, read with the id count of
the piece before, must be the cut's.  On device="cpu" the plain decode
runs in the same places, on a copy of the bytes.  `encode_codepoints`
cuts host codepoints the same way (`codepoint_pieces`), pads each piece
and copies its bucket.

An encoder handed a utils.profiling.StageStats as `stats` records, on the
caller's thread, `encode` around each call and inside it `host_pad`
(encode_bytes: the bytes into the staging buffer, once a call;
encode_codepoints: the padded bucket, once a piece), `stream_h2d`
(encode_bytes: the bytes' copy, the count and its read, then a later
piece's copy and count; encode_codepoints: the bucket's copy),
`device_dispatch` (encode_bytes: the decode's second pass, then the
features, probe and commit) and `device_fetch` (with `device_wait` inside:
the piece's id count; then, before the last piece, the ids' copy
enqueued), each once a piece, `fetch_unpack` (the last piece's ids' copy
and the host copy of the earlier ones) inside the last piece's
`device_fetch`, and counts the pieces (`stream_pieces`), the
positions the kernels ran (`stream_positions`, the pieces' buckets), the
probe table's rows once a piece (`stream_table_rows`) and, once a call of
encode_bytes, the bytes decoded on a card (`stream_card_decoded_bytes`, 0
on the CPU).
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from .core.vocab import Vocabulary, VocabIndex, build_index
from .engine_word import resolve_device
from .ops import commit as commit_ops
from .ops import match_fast
from .ops import text_features
from .ops import utf8_decode


LADDER_CAP = 1 << 22  # the bucket ladder's cap, and the most codepoints a piece holds

# The UTF-8 forms of the space-class codepoints a piece may end before.
_SPACE_BYTES = tuple(bytes([c]) for c in (9, 10, 11, 12, 13, 32)) + ("\u2581".encode(),)
_NEAR = 256  # offsets a cut looks back before it looks as far as its budget allows


def bucket_size(n: int) -> int:
    """Static padded size for a length-n input."""
    if n <= 128:
        return 128
    cap = LADDER_CAP
    if n <= cap:
        return 1 << (n - 1).bit_length()
    return ((n + cap - 1) // cap) * cap


def index_statics(index) -> dict:
    """The keyword statics of encode_padded from a VocabIndex (or a
    ShardedVocabIndex)."""
    return dict(
        max_len=int(index.max_len),
        max_probe=int(index.max_probe),
        log2_size=int(index.log2_size),
        mult1=int(index.mult1),
        mult2=int(index.mult2),
        unk_id=int(index.unk_token_id),
    )


def encode_padded(
    cp_pad: torch.Tensor,  # int32[n + max_len]
    n_valid: int,
    table: match_fast.ProbeTable,
    *,
    max_len: int,
    max_probe: int,
    log2_size: int,
    mult1: int,
    mult2: int,
    unk_id: int,
    combine=None,
):
    """Returns (ids int32[n] padded with -2, count int32 0-d tensor).
    combine: None, or a function that merges the matches against `table`
    with those of other table partitions before the commit
    (parallel/vocab_parallel.combine_partial_matches)."""
    n = cp_pad.shape[0] - max_len
    feats = text_features.compute_features(cp_pad[:n], n_valid, max_len)
    best_id, best_len = match_fast.match_positions(
        cp_pad,
        feats.window,
        feats.wp,
        table,
        max_len=max_len,
        max_probe=max_probe,
        log2_size=log2_size,
        mult1=mult1,
        mult2=mult2,
    )
    if combine is not None:
        best_id, best_len = combine(best_id, best_len)
    return commit_ops.commit(best_id, best_len, feats, n_valid, unk_id=unk_id)


def _plan(n: int, size: int, cap: int, locate, rank, last_space) -> list[tuple[int, int, int]]:
    """Pieces of a document of n codepoints and `size` offsets (bytes or
    codepoints), as (lo, hi, codepoints) offset ranges, each of at most `cap`
    codepoints unless no cut was found.  locate(k): the offset where
    codepoint k begins; rank(o): the codepoints before offset o;
    last_space(lo, hi): the last offset in [lo, hi] where a space-class
    codepoint begins, or -1.

    A piece ends just before the space-class codepoint nearest below the
    offset where the cap falls.  The cuts give up at most (ceil(n / cap)
    + 1) * cap - n codepoints in all (at least cap): then the first
    ceil(n / cap) pieces hold at least n - cap codepoints, so the pieces
    are at most ceil(n / cap) + 1.  A cut looks back no further than what
    is left of that budget; where no space-class codepoint lies there,
    the rest of the document is one piece."""
    budget = (-(-n // cap) + 1) * cap - n
    pieces, lo, before = [], 0, 0
    while n - before > cap:
        end = locate(before + cap)
        cut = last_space(max(lo + 1, end - min(_NEAR, budget)), end)
        if cut < 0 and budget > _NEAR:
            cut = last_space(max(lo + 1, end - budget), end)
        if cut < 0:
            break
        k = rank(cut) - before
        pieces.append((lo, cut, k))
        lo, before, budget = cut, before + k, budget - (cap - k)
    pieces.append((lo, size, n - before))
    return pieces


def codepoint_pieces(cps: np.ndarray, cap: int) -> list[tuple[int, int]]:
    """The pieces of int32 codepoints `cps`: (lo, hi) ranges."""
    n = cps.shape[0]

    def last_space(lo, hi):
        w = cps[lo : hi + 1]
        at = np.flatnonzero(((w >= 9) & (w <= 13)) | (w == 32) | (w == 0x2581))
        return lo + int(at[-1]) if at.size else -1

    return [(lo, hi) for lo, hi, _ in _plan(n, n, cap, int, int, last_space)]


def byte_pieces(raw: bytes, counted: utf8_decode.Counted, cap: int) -> list[tuple[int, int, int]]:
    """The pieces of UTF-8 bytes `raw`, whose count with its tiles'
    prefixes (utf8_decode.count_codepoints(..., prefixes=True)) is
    `counted`: (lo, hi, codepoints), byte ranges."""
    at = utf8_decode.Offsets(counted, raw)

    def last_space(lo, hi):
        return max(raw.rfind(p, lo, hi + len(p)) for p in _SPACE_BYTES)

    return _plan(counted.n, len(raw), cap, at.byte_of, at.codepoints_before, last_space)


def pad_codepoints(cps: np.ndarray, max_len: int) -> np.ndarray:
    """int32[bucket_size(n) + max_len]: cps, then zeros."""
    n = cps.shape[0]
    cp_pad = np.zeros(bucket_size(n) + max_len, dtype=np.int32)
    cp_pad[:n] = cps
    return cp_pad


class FastEncoder:
    """Replicated-vocab encoder; host-facing, device-computing."""

    def __init__(self, vocab: Vocabulary, index: VocabIndex | None = None, *, device="cuda"):
        """device: "cuda" (default; raises if no GPU is present) or "cpu"."""
        self.device = resolve_device(device)
        self.vocab = vocab
        self.index = index if index is not None else build_index(vocab)
        self.table = match_fast.pack_table(self.index, self.device)
        self._statics = index_statics(self.index)
        self.stats = None  # optional utils.profiling.StageStats
        self._slot = None  # the pinned staging buffer of encode_bytes, on a card
        self._slot_lock = threading.Lock()  # the slot is one call's until its count is read
        self._ids = threading.local()  # `out`: a calling thread's pinned buffer of _ids_buffer

    def _stage(self, name: str, nbytes: int = 0):
        st = self.stats
        return st.stage(name, nbytes) if st is not None else contextlib.nullcontext()

    def _count(self, name: str, n: int) -> None:
        if self.stats is not None:
            self.stats.count(name, n)

    def _staged(self, data) -> torch.Tensor:
        """The bytes as a host uint8 tensor to copy from: on a card a view
        of the pinned slot, which numpy fills (torch's pin_memory() and CPU
        copy_ fork its CPU thread pool: milliseconds a call on a card's
        host); on the CPU a writable copy of the bytes (torch warns on a
        read-only buffer).  Called under _slot_lock."""
        b = np.frombuffer(data, dtype=np.uint8)
        if self.device.type == "cpu":
            return torch.from_numpy(b.copy())
        if self._slot is None or self._slot.shape[0] < b.shape[0]:
            self._slot = torch.empty(b.shape[0], dtype=torch.uint8, pin_memory=True)
        self._slot.numpy()[: b.shape[0]] = b
        return self._slot[: b.shape[0]]

    def encode_bytes(self, data: bytes) -> np.ndarray:
        """Encode UTF-8 bytes (invalid bytes dropped, as the reference's
        decoder does); returns an int32 id array.  A call of p pieces reads
        the device p + 1 times: the decode's count (with the tiles'
        prefixes where the bytes pass the cap), then each piece's id
        count."""
        with self._stage("encode", len(data)), contextlib.ExitStack() as slot:
            slot.enter_context(self._slot_lock)
            with self._stage("host_pad"):
                host = self._staged(data)
            with self._stage("stream_h2d"):
                counted = utf8_decode.count_codepoints(host.to(self.device, non_blocking=True),
                                                       prefixes=len(data) > LADDER_CAP)
            self._count("stream_card_decoded_bytes", len(data) if self.device.type == "cuda" else 0)
            if counted.n == 0:
                return np.zeros(0, dtype=np.int32)
            pieces = [(0, len(data), counted.n)]
            if counted.n > LADDER_CAP:
                raw = data if isinstance(data, (bytes, bytearray)) else bytes(data)
                pieces = byte_pieces(raw, counted, LADDER_CAP)
            out, end, ran = self._ids_buffer([k for _, _, k in pieces]), 0, None
            for i, (lo, hi, k) in enumerate(pieces):
                if i:
                    with self._stage("stream_h2d"):
                        counted = utf8_decode.count_codepoints(
                            host[lo:hi].to(self.device, non_blocking=True), expect=k)
                    end = self._fetch(*ran, out, end)  # its read waits for this count too
                    ran = None  # frees the ids of the piece before, before this piece's arrays
                    utf8_decode.check(counted)
                elif len(pieces) > 1:
                    counted = utf8_decode.head(counted, hi, k)
                if i == len(pieces) - 1:
                    slot.close()  # the last piece's bytes are on the card
                with self._stage("device_dispatch"):
                    size = bucket_size(k) + self._statics["max_len"]
                    cp_dev = utf8_decode.write_codepoints(counted, size)
                    del counted  # the bytes and the count's scratch, before the features' peak
                    ran = (*encode_padded(cp_dev, k, self.table, **self._statics), k)
                    del cp_dev
            return self._fetch(*ran, out, end, last=True)

    def encode_codepoints(self, cps: np.ndarray) -> np.ndarray:
        """Encode a host codepoint array; returns an int32 id array."""
        with self._stage("encode"):
            cps = np.asarray(cps, dtype=np.int32)
            if cps.shape[0] == 0:
                return np.zeros(0, dtype=np.int32)
            pieces = codepoint_pieces(cps, LADDER_CAP)
            out, end, ran = self._ids_buffer([hi - lo for lo, hi in pieces]), 0, None
            for lo, hi in pieces:
                with self._stage("host_pad"):
                    cp_pad = torch.from_numpy(pad_codepoints(cps[lo:hi], self._statics["max_len"]))
                with self._stage("stream_h2d"):
                    cp_dev = cp_pad.to(self.device)
                if ran is not None:
                    end = self._fetch(*ran, out, end)
                    ran = None
                with self._stage("device_dispatch"):
                    ran = (*encode_padded(cp_dev, hi - lo, self.table, **self._statics), hi - lo)
                    del cp_dev
            return self._fetch(*ran, out, end, last=True)

    def _ids_buffer(self, sizes: list[int]) -> torch.Tensor | None:
        """The host buffer of the ids of a call's pieces before its last, of
        the given codepoints (ids are at most as many); None for one piece.
        On a card pinned, so each piece's ids go by DMA, and kept by the
        calling thread (grown to its largest call): a pinned allocation a
        call cost 0.1-0.5 ms of a 10 MB call on an H100's host."""
        n = sum(sizes[:-1])
        if not n:
            return None
        if self.device.type == "cpu":
            return torch.empty(n, dtype=torch.int32)
        out = getattr(self._ids, "out", None)
        if out is None or out.shape[0] < n:
            out = self._ids.out = torch.empty(n, dtype=torch.int32, pin_memory=True)
        return out

    def _fetch(self, ids, count, n: int, out: torch.Tensor | None, end: int, *, last: bool = False):
        """A piece's host read of the device (its id count).  The ids of a
        piece before the call's last are copied on the stream into `out`
        after the `end` ids of the pieces before it, and the ids' new end
        is returned; the last piece's ids go straight into the call's
        result, behind those in `out` (a copy to pageable memory, which
        waits for the stream, so the earlier copies are done), which is
        returned."""
        with self._stage("device_fetch"):
            with self._stage("device_wait"):
                count = int(count)
            if not last:
                out[end : end + count].copy_(ids[:count], non_blocking=True)
            else:
                with self._stage("fetch_unpack"):
                    result = torch.empty(end + count, dtype=torch.int32)
                    result[end:].copy_(ids[:count])
                    result = result.numpy()
                    if end:
                        result[:end] = out[:end].numpy()
        self._count("stream_pieces", 1)
        self._count("stream_positions", bucket_size(n))
        self._count("stream_table_rows", self.table.slots.shape[0])
        return result if last else end + count

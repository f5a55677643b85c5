"""Fast-stream encoder: the whole text as one program on the device.

The counterpart of wordpiece_tpu/engine.py.  Pipeline, on the encoder's
device:
  codepoints -> text features -> per-position longest match -> greedy
  commit -> compacted ids.

Inputs are padded to a bucket size (powers of two between 2^7 and 2^22,
then multiples of 2^22), as the JAX engine pads them for its compiled
programs, so both engines see the same shapes.  On a CUDA device each step
is a hand-written kernel: the features csrc/text_features.cu
(ops/text_features.py), the match csrc/match_fast.cu (ops/match_fast.py)
and the commit csrc/commit.cu (ops/commit.py), one call of each an encode.
On device="cpu" the same wrappers run their plain PyTorch versions;
nothing falls back from one to the other.

`encode_bytes` decodes the UTF-8 on the device: the bytes go to the card
through one pinned staging buffer the encoder keeps (grown to the largest
call), the decode's first pass counts the codepoints (csrc/utf8_decode.cu,
ops/utf8_decode.py; the host reads the count to size the bucket) and its
second writes them into the padded bucket.  On device="cpu" the plain
decode runs in the same place, on a copy of the bytes.
`encode_codepoints` pads host codepoints and copies the bucket.

An encoder handed a utils.profiling.StageStats as `stats` records, on the
caller's thread, `encode` around each call and inside it `host_pad`
(encode_bytes: the bytes into the staging buffer; encode_codepoints: the
padded bucket), `stream_h2d` (encode_bytes: the bytes' copy, the count and
its read), `device_dispatch` (encode_bytes: the decode's second pass, then
the features, probe and commit) and `device_fetch` (with `device_wait` and
`fetch_unpack` inside), and counts once a call the positions the kernels
ran (`stream_positions`), the probe table's rows (`stream_table_rows`) and,
in encode_bytes, the bytes decoded on a card (`stream_card_decoded_bytes`,
0 on the CPU).
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


def bucket_size(n: int) -> int:
    """Static padded size for a length-n input."""
    if n <= 128:
        return 128
    cap = 1 << 22
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
        decoder does); returns an int32 id array.  The call's one extra
        host read is the decode's count."""
        with self._stage("encode", len(data)):
            with self._slot_lock:
                with self._stage("host_pad"):
                    host = self._staged(data)
                with self._stage("stream_h2d"):
                    counted = utf8_decode.count_codepoints(host.to(self.device, non_blocking=True))
            self._count("stream_card_decoded_bytes", len(data) if self.device.type == "cuda" else 0)
            n = counted.n
            if n == 0:
                return np.zeros(0, dtype=np.int32)
            with self._stage("device_dispatch"):
                size = bucket_size(n) + self._statics["max_len"]
                cp_dev = utf8_decode.write_codepoints(counted, size)
                del counted  # the bytes and the count's scratch, before the features' peak
                ids, count = encode_padded(cp_dev, n, self.table, **self._statics)
            return self._fetch(ids, count, n)

    def encode_codepoints(self, cps: np.ndarray) -> np.ndarray:
        """Encode a host codepoint array; returns an int32 id array."""
        with self._stage("encode"):
            n = len(cps)
            if n == 0:
                return np.zeros(0, dtype=np.int32)
            with self._stage("host_pad"):
                cp_pad = torch.from_numpy(pad_codepoints(np.asarray(cps, dtype=np.int32),
                                                         self._statics["max_len"]))
            with self._stage("stream_h2d"):
                cp_dev = cp_pad.to(self.device)
            with self._stage("device_dispatch"):
                ids, count = encode_padded(cp_dev, n, self.table, **self._statics)
            return self._fetch(ids, count, n)

    def _fetch(self, ids, count, n: int) -> np.ndarray:
        """The call's host read of the device (the id count), then the
        ids' copy."""
        with self._stage("device_fetch"):
            with self._stage("device_wait"):
                count = int(count)
            with self._stage("fetch_unpack"):
                out = ids[:count].cpu().numpy()
        self._count("stream_positions", bucket_size(n))
        self._count("stream_table_rows", self.table.slots.shape[0])
        return out

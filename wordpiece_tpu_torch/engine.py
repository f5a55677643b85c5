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

An encoder handed a utils.profiling.StageStats as `stats` records, on the
caller's thread, `encode` around each call and inside it `host_decode`
(encode_bytes only), `host_pad`, `stream_h2d`, `device_dispatch` and
`device_fetch` (with `device_wait` and `fetch_unpack` inside), and counts
the positions the kernels ran (`stream_positions`) and the probe table's
rows (`stream_table_rows`) once a call.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .core.unicode import decode_utf8
from .core.vocab import Vocabulary, VocabIndex, build_index
from .engine_word import resolve_device
from .ops import commit as commit_ops
from .ops import match_fast
from .ops import text_features


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

    def _stage(self, name: str, nbytes: int = 0):
        st = self.stats
        return st.stage(name, nbytes) if st is not None else contextlib.nullcontext()

    def encode_bytes(self, data: bytes) -> np.ndarray:
        """Encode UTF-8 bytes (invalid bytes dropped, as the reference's
        decoder does); returns an int32 id array."""
        with self._stage("encode", len(data)):
            with self._stage("host_decode", len(data)):
                cps = decode_utf8(data)
            return self._encode(cps)

    def encode_codepoints(self, cps: np.ndarray) -> np.ndarray:
        """Encode a host codepoint array; returns an int32 id array."""
        with self._stage("encode"):
            return self._encode(cps)

    def _encode(self, cps) -> np.ndarray:
        """One host read of the device per call (the id count), then the
        ids' copy."""
        n = len(cps)
        if n == 0:
            return np.zeros(0, dtype=np.int32)
        max_len = self._statics["max_len"]
        with self._stage("host_pad"):
            cp_pad = torch.from_numpy(pad_codepoints(np.asarray(cps, dtype=np.int32), max_len))
        with self._stage("stream_h2d"):
            cp_dev = cp_pad.to(self.device)
        with self._stage("device_dispatch"):
            ids, count = encode_padded(cp_dev, n, self.table, **self._statics)
        with self._stage("device_fetch"):
            with self._stage("device_wait"):
                count = int(count)
            with self._stage("fetch_unpack"):
                out = ids[:count].cpu().numpy()
        if self.stats is not None:
            self.stats.count("stream_positions", bucket_size(n))
            self.stats.count("stream_table_rows", self.table.slots.shape[0])
        return out

"""Vocabulary-parallel matching: the probe table sharded over the ranks of
a vocab group.  The counterpart of wordpiece_tpu/parallel/vocab_parallel.py.

Active tokens are partitioned round-robin by id; each rank probes only its
partition's open-addressing table, and the partial per-position matches
combine with a max over (len, then id) across the vocab group.  A token
string lives in exactly one partition, so two partitions never match the
same (position, length, kind) with different tokens and the combine is
exact.  Only the (len, id) arrays cross between ranks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..core.vocab import Vocabulary, VocabIndex, build_index
from ..ops.match_fast import pack_table_np


@dataclasses.dataclass
class ShardedVocabIndex:
    tables: np.ndarray  # int32[V, S, 5]
    mult1: int
    mult2: int
    max_len: int
    max_probe: int
    unk_token_id: int
    log2_size: int
    n_parts: int


def build_index_sharded(vocab: Vocabulary, n_parts: int) -> ShardedVocabIndex:
    """Partition active tokens round-robin by id; one sub-table per part,
    all of one size."""

    def sub_vocab(p: int) -> Vocabulary:
        # Tokens outside this partition are marked malformed.
        return Vocabulary(
            flat=vocab.flat,
            offsets=vocab.offsets,
            is_prefix=vocab.is_prefix,
            is_special=vocab.is_special,
            is_malformed=vocab.is_malformed | (np.arange(vocab.size) % n_parts != p),
            unk_token_id=vocab.unk_token_id,
        )

    parts: list[VocabIndex] = [build_index(sub_vocab(p)) for p in range(n_parts)]
    size = max(ix.size for ix in parts)
    log2 = int(size).bit_length() - 1
    rebuilt = [
        ix if ix.size == size else build_index(sub_vocab(p), min_table_size=size)
        for p, ix in enumerate(parts)
    ]
    m1 = rebuilt[0].mult1
    m2 = rebuilt[0].mult2
    if any(ix.mult1 != m1 or ix.mult2 != m2 for ix in rebuilt):  # pragma: no cover
        raise RuntimeError("vocab partitions disagree on hash multipliers")
    return ShardedVocabIndex(
        tables=np.stack([pack_table_np(ix) for ix in rebuilt]),
        mult1=m1,
        mult2=m2,
        max_len=max(ix.max_len for ix in rebuilt),
        max_probe=max(ix.max_probe for ix in rebuilt),
        unk_token_id=vocab.unk_token_id,
        log2_size=log2,
        n_parts=n_parts,
    )


def combine_partial_matches(best_id: torch.Tensor, best_len: torch.Tensor, group):
    """Max-combine this rank's partition matches with those of the other
    ranks of the vocab `group`: (best_id, best_len) of the longest match
    over all partitions.  Two all_reduce(MAX) calls."""
    max_len = best_len.clone()
    dist.all_reduce(max_len, op=dist.ReduceOp.MAX, group=group)
    mine = torch.where(best_len == max_len, best_id, -1)
    dist.all_reduce(mine, op=dist.ReduceOp.MAX, group=group)
    return mine, max_len

"""Data-parallel word engine over a grid of torch.distributed ranks.

The counterpart of wordpiece_tpu/parallel/word_sharding.py.  The word
kernel is embarrassingly parallel over units, so the sharded device step
is: every bucket's units are padded with all-space rows (they emit
nothing) to a multiple of the data axis and split contiguously over it,
the length tables are replicated, and rank d runs the fused match+commit
kernel on its slice d of every bucket.  The slices' emit matrices and
per-unit counts come back to every rank of the data group in one
all_gather.  Every rank then compacts the whole dispatch with the
compaction kernel, so the host reads one compact vector per chunk, as on
one device; the compaction's scan of the gathered counts writes the
dispatch's total (the psum of the JAX version, the reference's summed
sizes, src/fast.cpp:127-130), so the total needs no collective of its own.

Optional vocab axis (expert-parallel tables, a grid made with
make_mesh(n_data, n_vocab), the ("data", "vocab") mesh of the JAX
version, of any length, 1 x 1 included): the candidate rows of the
length tables are partitioned over the ranks of a vocab group
(shard_word_tables); rank (d, v) runs the match kernel on its slice
against partition v, the partial matches, one packed int32 per position
((len << 24) | id, 0 for none: ops/word_kernel.pack_matches), combine with
ONE all_reduce(MAX) (the longest length, then the largest id: exact,
because a token lives in exactly one partition; the JAX version's two
pmax give the same), and the commit kernel runs on the combined matches,
replicated along the vocab axis.  A 2-D dispatch issues two collectives:
that all_reduce and the gather.

SPMD: every rank of the grid calls encode_bytes with the same bytes, so
every rank's pipeline cuts the same chunks and dispatches the same
buckets; each rank returns the whole id stream.  Every collective of a
dispatch is issued in WordEncoder._device_step, on the one thread that
prepares chunks, so all ranks issue them in the same order.  On CUDA every
rank runs on cuda:rank_card(rank) with the nccl backend, on the CPU
with gloo (parallel/sharding.rank_device); a CUDA encoder never falls back.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..core.length_tables import LengthTables, load_length_tables
from ..engine_word import WordEncoder, _narrow
from ..ops import word_kernel_cuda as wk
from .sharding import ProcessGrid, make_mesh, rank_device


def data_slices(mats, mesh: ProcessGrid) -> list[np.ndarray]:
    """This rank's slice of every bucket: each unit matrix padded with
    all-space rows to a multiple of n_data units, then rows [d * r, (d +
    1) * r) of it, r = the padded units / n_data."""
    if mesh.d is None:
        raise RuntimeError("this rank is outside the grid")
    out = []
    for mat in mats:
        u, w = mat.shape
        rows = -(-u // mesh.n_data)
        padded = np.full((rows * mesh.n_data, w), 32, dtype=mat.dtype)
        padded[:u] = mat
        out.append(np.ascontiguousarray(padded[mesh.d * rows : (mesh.d + 1) * rows]))
    return out


def _gather_slices(emits, counts: torch.Tensor, mesh: ProcessGrid):
    """Every rank's slice of every bucket, on every rank of the data group,
    in one all_gather of the slices' emits and counts: (emit matrices
    [n_data * r_b, W_b], counts int32[n_data * r_b] per bucket)."""
    flat = torch.cat([e.reshape(-1) for e in emits] + [counts])
    parts = [torch.empty_like(flat) for _ in range(mesh.n_data)]
    dist.all_gather(parts, flat, group=mesh.data_group)
    whole = torch.stack(parts)  # [n_data, slice words]
    out_emits, out_counts = [], []
    off = 0
    for e in emits:
        r, w = e.shape
        # The compaction kernel reads contiguous rows; with one row a slice
        # (r == 1) the reshape is a view whose rows stride over the parts.
        out_emits.append(whole[:, off : off + r * w].reshape(mesh.n_data * r, w).contiguous())
        off += r * w
    for e in emits:
        r = e.shape[0]
        out_counts.append(whole[:, off : off + r].reshape(-1))
        off += r
    return out_emits, out_counts


def word_encode_data_parallel(cps, tables, *, mesh: ProcessGrid):
    """Sharded match+commit, called by every rank of the grid with its
    slice of every bucket (data_slices, on this rank's device) and the
    replicated tables (core.length_tables.DeviceTables): one fused kernel
    launch on the slices, then the gather (_gather_slices).  Returns
    (emit matrices [n_data * r_b, W_b], counts int32[n_data * r_b] per
    bucket); the counts' sum is the dispatch's total."""
    n = sum(int(cp.shape[0]) for cp in cps)
    counts = torch.empty(n, dtype=torch.int32, device=tables.packed.device)
    emits = wk.word_match_commit_multi(cps, tables, counts=counts)
    return _gather_slices(emits, counts, mesh)


def shard_word_tables(tables, n_vocab: int):
    """Partition the per-length candidate rows across the vocab axis.

    Each length l's B_l rows pad to a multiple of n_vocab (empty slots:
    id == -1, never hit) and split contiguously; the returned arrays
    stack shard-major, so rows [v * R, (v + 1) * R) are partition v.
    rows_off_shard is uniform across shards.  Equal to the JAX package's
    shard_word_tables, array for array.
    """
    k1, k2, tid = tables.k1, tables.k2, tables.tid
    offs = tables.rows_off
    rows_off_shard = [0, 0]
    blocks = [[] for _ in range(n_vocab)]
    for l in range(1, tables.max_len + 1):
        lo, hi = int(offs[l]), int(offs[l + 1])
        b = hi - lo
        bp = -(-b // n_vocab) if b else 0
        rows_off_shard.append(rows_off_shard[-1] + bp)
        if bp == 0:
            continue
        for v in range(n_vocab):
            bk1 = np.zeros((bp, 128), np.int32)
            bk2 = np.zeros((bp, 128), np.int32)
            bid = np.full((bp, 128), -1, np.int32)
            s = lo + v * bp
            e = min(hi, s + bp)
            if s < hi:
                bk1[: e - s] = k1[s:e]
                bk2[: e - s] = k2[s:e]
                bid[: e - s] = tid[s:e]
            blocks[v].append((bk1, bk2, bid))
    if rows_off_shard[-1] == 0:
        # No active tokens: 1 empty row per shard keeps shapes valid; all
        # per-length counts stay 0 so the rows are never probed.
        k1p = np.zeros((n_vocab, 128), np.int32)
        k2p = np.zeros((n_vocab, 128), np.int32)
        tidp = np.full((n_vocab, 128), -1, np.int32)
    else:
        k1p = np.concatenate([b[0] for blks in blocks for b in blks], axis=0)
        k2p = np.concatenate([b[1] for blks in blocks for b in blks], axis=0)
        tidp = np.concatenate([b[2] for blks in blocks for b in blks], axis=0)
    return k1p, k2p, tidp, tuple(rows_off_shard)


def partition_tables(tables, n_vocab: int, v: int) -> LengthTables:
    """Partition v of shard_word_tables(tables, n_vocab) as LengthTables
    with the whole table's multipliers, salts, max_len and UNK id, for
    core.length_tables.load_length_tables (which packs the partition's
    own slot lists; the lanes are the whole table's)."""
    if not 0 <= v < n_vocab:
        raise ValueError(f"partition {v} of {n_vocab}")
    k1p, k2p, tidp, rows_off = shard_word_tables(tables, n_vocab)
    r = k1p.shape[0] // n_vocab
    rows = slice(v * r, (v + 1) * r)
    return LengthTables(
        k1=k1p[rows], k2=k2p[rows], tid=tidp[rows], rows_off=list(rows_off),
        mult1=tables.mult1, mult2=tables.mult2, lane_salts=tuple(tables.lane_salts),
        max_len=tables.max_len, unk_token_id=tables.unk_token_id,
    )


def word_encode_2d_parallel(cps, tables, *, mesh: ProcessGrid):
    """2-D word engine, called by every rank of the grid with its data
    slice of every bucket (data_slices) and its vocab partition's tables
    (partition_tables, loaded on this rank's device): one match kernel
    launch against the partition into one flat buffer of packed matches,
    their max over the vocab group in one all_reduce, one commit kernel
    launch on the combined matches, then the gather over the data group.
    Returns what word_encode_data_parallel returns."""
    dev = tables.packed.device
    flat = torch.empty(sum(int(cp.shape[0]) * int(cp.shape[1]) for cp in cps),
                       dtype=torch.int32, device=dev)
    packed = wk.word_match_packed(cps, tables, out=flat)
    dist.all_reduce(flat, op=dist.ReduceOp.MAX, group=mesh.vocab_group)
    counts = torch.empty(sum(int(cp.shape[0]) for cp in cps), dtype=torch.int32, device=dev)
    emits = wk.word_commit_packed(
        cps, packed, max_len=tables.max_len, unk_id=tables.unk_id, counts=counts
    )
    return _gather_slices(emits, counts, mesh)


class ShardedWordEncoder:
    """Multi-rank word engine (host-facing).

    Wraps WordEncoder's host pipeline and replaces its device step
    (WordEncoder._device_step) with the sharded one:
    word_encode_data_parallel on a 1-D grid, word_encode_2d_parallel on a
    grid with a vocab axis ("vocab" in mesh.axis_names).  Every rank of
    the grid calls encode_bytes with the same bytes and gets the whole id
    stream."""

    def __init__(self, vocab, mesh: ProcessGrid | None = None, *, device="cuda"):
        self.mesh = mesh if mesh is not None else make_mesh()
        if self.mesh.d is None:
            raise RuntimeError("this rank is outside the grid")
        self.vocab = vocab
        inner = self._inner = WordEncoder(vocab, device=rank_device(device))
        if "vocab" in self.mesh.axis_names:
            part = partition_tables(inner.tables, self.mesh.n_vocab, self.mesh.v)
            self._encode, self._tables = word_encode_2d_parallel, load_length_tables(part, inner.device)
            if inner._stream is not None:  # the partition was copied on the default stream
                inner._stream.wait_stream(torch.cuda.current_stream(inner.device))
        else:
            self._encode, self._tables = word_encode_data_parallel, inner.dtables
        inner._device_step = self._device_step  # type: ignore[method-assign]

    def _device_step(self, mats, cap: int, keep: list):
        slices = data_slices([_narrow(m) for m in mats], self.mesh)
        emits, counts = self._encode(
            [self._inner._to_device(s, keep) for s in slices], self._tables, mesh=self.mesh
        )
        return _compact(mats, emits, counts, cap)

    def encode_bytes(self, data: bytes) -> np.ndarray:
        return self._inner.encode_bytes(data)


def _compact(mats, emits, counts, cap: int):
    """The gathered dispatch -> (compact vector, emit matrices): the pad
    rows cut off, the counts written into the vector's counts segment, one
    compaction launch."""
    units = [int(m.shape[0]) for m in mats]
    emits = [e[:u] for e, u in zip(emits, units)]
    n = sum(units)
    fused = torch.empty(1 + n + cap, dtype=torch.int32, device=emits[0].device)
    fused[1 : 1 + n] = torch.cat([c[:u] for c, u in zip(counts, units)])
    return wk.compact_from_counts(emits, fused, cap), emits

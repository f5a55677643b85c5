"""Data-parallel corpus sharding over a grid of torch.distributed ranks.

The counterpart of wordpiece_tpu/parallel/sharding.py.  The codepoint
stream is split on the host at whitespace-safe boundaries (chunk ends
extended to the next space, so no token crosses a boundary,
src/fast.cpp:113-115) into a [n_shards, shard_cap] array, and each rank
encodes the shard it owns with the fast-stream program
(engine.encode_padded).  The reference's summed sizes and concatenation
(src/fast.cpp:125-137) become an all_reduce(SUM) of the per-shard counts
over the data group and an all_gather of the per-shard ids, so every rank
returns the whole stream.

A JAX Mesh becomes a ProcessGrid (make_mesh): rank r of the grid sits at
(d, v) = (r // n_vocab, r % n_vocab), the layout of
np.asarray(devices).reshape(n_data, n_vocab).  The optional vocab axis
shards the probe table (parallel/vocab_parallel.py): the ranks of one data
row each probe their table partition and max-combine the matches.

JAX's single-controller call becomes SPMD: every rank calls with the same
codepoints.  On CUDA every rank runs on cuda:rank_card(rank) (LOCAL_RANK,
else rank % device_count) with the nccl backend; on the CPU with gloo.  A
CUDA encoder never falls back to gloo or to the CPU.
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial

import numpy as np
import torch
import torch.distributed as dist

from ..core import unicode as uni
from ..core.vocab import build_index
from ..engine import encode_padded, index_statics
from ..engine_word import resolve_device
from ..ops import match_fast
from .vocab_parallel import combine_partial_matches


@dataclasses.dataclass(frozen=True)
class ProcessGrid:
    """A (data, vocab) grid of ranks: the port's counterpart of a JAX Mesh.
    d and v are this rank's coordinates (None on a rank outside the grid);
    data_group holds the ranks of this rank's column (same v, every d: the
    "data" axis), vocab_group those of its row (same d, every v).
    axis_names is ("data",) for a 1-D grid (n_vocab == 1) and ("data",
    "vocab") for a grid made with a vocab axis, of any length."""

    n_data: int
    n_vocab: int
    ranks: tuple  # global rank at (d, v) is ranks[d * n_vocab + v]
    d: int | None
    v: int | None
    data_group: object
    vocab_group: object
    axis_names: tuple = ("data",)


def make_mesh(n_data: int | None = None, n_vocab: int | None = None, group=None) -> ProcessGrid:
    """The first n_data * n_vocab ranks of `group` (default: the world) as a
    (data, vocab) grid; without n_vocab, a 1-D data grid.  Every rank of
    the world must call it, with the same arguments: it creates every
    subgroup, in the same order, on every rank (dist.new_group's rule)."""
    axes = ("data",) if n_vocab is None else ("data", "vocab")
    n_vocab = 1 if n_vocab is None else n_vocab
    if group is None:
        ranks = list(range(dist.get_world_size()))
    else:
        ranks = list(dist.get_process_group_ranks(group))
    if n_data is None:
        n_data = len(ranks) // n_vocab
    if n_data < 1 or n_vocab < 1 or n_data * n_vocab > len(ranks):
        raise ValueError(f"a {n_data} x {n_vocab} grid needs more than the {len(ranks)} ranks")
    ranks = tuple(ranks[: n_data * n_vocab])
    data_groups = [
        dist.new_group([ranks[d * n_vocab + v] for d in range(n_data)]) for v in range(n_vocab)
    ]
    vocab_groups = [
        dist.new_group([ranks[d * n_vocab + v] for v in range(n_vocab)]) for d in range(n_data)
    ]
    me = dist.get_rank()
    if me not in ranks:
        return ProcessGrid(n_data, n_vocab, ranks, None, None, None, None, axes)
    d, v = divmod(ranks.index(me), n_vocab)
    return ProcessGrid(n_data, n_vocab, ranks, d, v, data_groups[v], vocab_groups[d], axes)


def rank_card(rank: int) -> int:
    """This process's card, given its global rank: LOCAL_RANK where the
    launcher sets it (torchrun), else rank % device_count (one host)."""
    local = os.environ.get("LOCAL_RANK")
    return int(local) if local is not None else rank % torch.cuda.device_count()


def rank_device(device) -> torch.device:
    """This rank's device: cuda:rank_card(rank) with the nccl backend for
    "cuda", the CPU with gloo for "cpu".  Raises on any other pairing."""
    dev = resolve_device(device)
    backend = dist.get_backend()
    if dev.type == "cuda":
        if backend != "nccl":
            raise RuntimeError(f"a CUDA encoder needs the nccl backend, not {backend}")
        if dev.index is None:
            dev = torch.device("cuda", rank_card(dist.get_rank()))
        return dev
    if backend != "gloo":
        raise RuntimeError(f"a CPU encoder needs the gloo backend, not {backend}")
    return dev


def split_whitespace_safe(cps: np.ndarray, space_mask: np.ndarray, n_shards: int):
    """Split a codepoint stream into n_shards chunks ending at spaces.

    Returns (starts, ends) arrays; chunks may be empty if the text has
    long space-free runs.  Matches the reference chunking: each boundary
    is advanced until it lands on a space (src/fast.cpp:113-115).
    """
    n = cps.shape[0]
    base = n // n_shards + (1 if n % n_shards else 0)
    starts, ends = [], []
    begin = 0
    for _ in range(n_shards):
        if begin >= n:
            starts.append(n)
            ends.append(n)
            continue
        end = min(n, begin + base)
        while end < n and not space_mask[end]:
            end += 1
        starts.append(begin)
        ends.append(end)
        begin = end
    return np.asarray(starts), np.asarray(ends)


def shard_codepoints(cps: np.ndarray, n_shards: int, pad_multiple: int = 128):
    """Host-side sharding: returns (cp_shards [D, cap], lengths [D])."""
    space_mask = np.asarray(uni.is_space(cps.astype(np.uint32)))
    starts, ends = split_whitespace_safe(cps, space_mask, n_shards)
    lens = ends - starts
    cap = int(max(int(lens.max()), 1))
    cap = ((cap + pad_multiple - 1) // pad_multiple) * pad_multiple
    out = np.zeros((n_shards, cap), dtype=np.int32)
    for d in range(n_shards):
        out[d, : lens[d]] = cps[starts[d] : ends[d]]
    return out, lens.astype(np.int32)


def assemble_ids(ids: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Ragged host-side concatenation of per-shard id streams."""
    return np.concatenate([ids[d, : int(c)] for d, c in enumerate(counts)]) if len(counts) else np.zeros(0, np.int32)


def _gather_shards(ids: torch.Tensor, count: torch.Tensor, mesh: ProcessGrid):
    """Every shard's ids and count, on every rank of the data group: (ids
    int32[D, largest count] padded with -2, counts int32[D], total int32
    0-d).  One host read: the largest count, which sizes the gather."""
    count = count.reshape(1).to(torch.int32)
    total = count.clone()
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=mesh.data_group)
    counts = [torch.empty_like(count) for _ in range(mesh.n_data)]
    dist.all_gather(counts, count, group=mesh.data_group)
    counts = torch.cat(counts)
    width = int(counts.max())
    rows = [torch.empty(width, dtype=torch.int32, device=ids.device) for _ in range(mesh.n_data)]
    if width:
        dist.all_gather(rows, ids[:width].contiguous(), group=mesh.data_group)
    return torch.stack(rows), counts, total[0]


def _own_row(cp_shards: np.ndarray, lengths: np.ndarray, mesh: ProcessGrid, device):
    if mesh.d is None:
        raise RuntimeError("this rank is outside the grid")
    if cp_shards.shape[0] != mesh.n_data or lengths.shape[0] != mesh.n_data:
        raise ValueError(f"{cp_shards.shape[0]} shards for a data axis of {mesh.n_data}")
    row = torch.from_numpy(np.ascontiguousarray(cp_shards[mesh.d], dtype=np.int32))
    return row.to(device), int(lengths[mesh.d])


def encode_data_parallel(
    cp_shards: np.ndarray,  # int32[D, cap + max_len] (already tail-padded), same on every rank
    lengths: np.ndarray,  # int32[D]
    table: match_fast.ProbeTable,  # on this rank's device (replicated)
    *,
    mesh: ProcessGrid,
    max_len: int,
    max_probe: int,
    log2_size: int,
    mult1: int,
    mult2: int,
    unk_id: int,
):
    """Sharded encode, called by every rank of the grid: this rank encodes
    shard mesh.d.  Returns (ids [D, largest count], counts [D], total) on
    this rank's device; the counts are summed with all_reduce(SUM) over the
    data group (the psum of the JAX version).  Each rank's commit walks its
    own shard to the fixed point before any collective."""
    row, n_valid = _own_row(cp_shards, lengths, mesh, table.device)
    ids, count = encode_padded(
        row, n_valid, table, max_len=max_len, max_probe=max_probe, log2_size=log2_size,
        mult1=mult1, mult2=mult2, unk_id=unk_id,
    )
    return _gather_shards(ids, count, mesh)


def encode_2d_parallel(
    cp_shards: np.ndarray,  # int32[D, cap + max_len], same on every rank
    lengths: np.ndarray,  # int32[D]
    table: match_fast.ProbeTable,  # this rank's vocab partition: load_table(tables[mesh.v])
    *,
    mesh: ProcessGrid,
    max_len: int,
    max_probe: int,
    log2_size: int,
    mult1: int,
    mult2: int,
    unk_id: int,
):
    """(data, vocab) grid: the corpus data-parallel, the probe table
    vocab-parallel (parallel/vocab_parallel.py).  Rank (d, v) matches shard
    d against partition v; the partial matches max-combine over the vocab
    group; the commit runs on every rank of the row.  Returns what
    encode_data_parallel returns."""
    row, n_valid = _own_row(cp_shards, lengths, mesh, table.device)
    ids, count = encode_padded(
        row, n_valid, table, max_len=max_len, max_probe=max_probe, log2_size=log2_size,
        mult1=mult1, mult2=mult2, unk_id=unk_id,
        combine=partial(combine_partial_matches, group=mesh.vocab_group),
    )
    return _gather_shards(ids, count, mesh)


def pad_shards(shards: np.ndarray, max_len: int) -> np.ndarray:
    """[D, cap] shards -> [D, cap + max_len], zero tail."""
    out = np.zeros((shards.shape[0], shards.shape[1] + max_len), dtype=np.int32)
    out[:, : shards.shape[1]] = shards
    return out


class ShardedFastEncoder:
    """Data-parallel encoder over a 1-D grid of ranks (host-facing).  Every
    rank of the grid calls encode_codepoints with the same codepoints and
    gets the whole id stream back."""

    def __init__(self, vocab, mesh: ProcessGrid | None = None, index=None, *, device="cuda"):
        self.vocab = vocab
        self.mesh = mesh if mesh is not None else make_mesh()
        if self.mesh.n_vocab != 1:
            raise ValueError("ShardedFastEncoder takes a 1-D grid (n_vocab == 1)")
        self.device = rank_device(device)
        self.index = index if index is not None else build_index(vocab)
        self.table = match_fast.pack_table(self.index, self.device)
        self._statics = index_statics(self.index)

    def encode_codepoints(self, cps: np.ndarray) -> np.ndarray:
        cps = np.asarray(cps, dtype=np.int32)
        if cps.shape[0] == 0:
            return np.zeros(0, dtype=np.int32)
        shards, lens = shard_codepoints(cps, self.mesh.n_data)
        ids, counts, _total = encode_data_parallel(
            pad_shards(shards, self._statics["max_len"]), lens, self.table, mesh=self.mesh,
            **self._statics)
        return assemble_ids(ids.cpu().numpy(), counts.cpu().numpy())

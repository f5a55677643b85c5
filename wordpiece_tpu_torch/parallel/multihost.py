"""Multi-process execution path of the word engine.

The counterpart of wordpiece_tpu/parallel/multihost.py.  The reference is
single-process shared-memory (its only "collectives" are summed sizes and
a memcpy concat, src/fast.cpp:125-137).  Here each process of a
torch.distributed group:

 - forms the group with initialize_distributed (a wrapper of
   torch.distributed.init_process_group that binds the rank's card first);
 - owns a whitespace-safe byte shard of the corpus (file_shard_bounds:
   the multi-process analogue of the reference's space-snapped chunking,
   src/fast.cpp:113-115), segments and dedupes it with the native
   runtime, and encodes it on its own card, cuda:rank_card(rank);
 - keeps its own id stream (the concatenation of the processes' streams
   in rank order is the whole corpus's);
 - sums the global id count with one all_reduce(SUM) over the data group.

Where this differs from the JAX package: there the device step is one
shard_map program over a mesh of every process's devices, which is a
collective, so every process must enter it with the same shapes and the
same number of times.  That forces the per-bucket row agreement by
all-gathered max (JAX multihost.py:229), lockstep_dispatch (a dispatch
for every chunk) and the n_chunks agreement by max (:285-289).  In the
port each process's units run on its own card and its own stream, so the
device step has no collective, and all three are dropped: each process's
pipeline chunks, routes small batches to the host oracle and dispatches as
a one-card WordEncoder does.  The ids are the same, and the one
collective, the total's all_reduce, comes after the encode on every
process.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ..core.unicode import find_space_cut
from ..engine_word import WordEncoder, resolve_device
from .sharding import ProcessGrid, make_mesh, rank_card, rank_device


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device=None,
) -> None:
    """Form the process group (torch.distributed.init_process_group): nccl
    for device "cuda", gloo for "cpu"; without `device`, nccl where CUDA
    is available, else gloo.  For nccl the rank's card is bound first
    (torch.cuda.set_device, and device_id= of the group): LOCAL_RANK, else
    rank % device_count (parallel/sharding.rank_card), so that the
    communicator, its barriers and rank_device all use that card.  No-op
    for one process with no coordinator, and when a group already exists.
    `coordinator_address` is "host:port" (or any init_method URL); without
    it the group forms from the environment (env://)."""
    if coordinator_address is None and num_processes in (None, 1):
        return  # single process: nothing to form
    if dist.is_initialized():
        return  # already formed by the launcher
    if coordinator_address is None:
        init = "env://"
    elif "://" in coordinator_address:
        init = coordinator_address
    else:
        init = f"tcp://{coordinator_address}"
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    kwargs = {}
    if resolve_device(device).type == "cuda":
        rank = process_id if process_id is not None else int(os.environ["RANK"])
        card = torch.device("cuda", rank_card(rank))
        torch.cuda.set_device(card)
        kwargs["device_id"] = card
    dist.init_process_group(
        "nccl" if kwargs else "gloo",
        init_method=init,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
        **kwargs,
    )


def file_shard_bounds(path: str, process_id: int, num_processes: int) -> tuple[int, int]:
    """[start, end) byte range of `path` owned by `process_id`.

    Boundaries are the first space-class cut point at-or-after i*size/n
    (scanning a bounded window; core.unicode.find_space_cut — ASCII
    whitespace or U+2581, so newline-only corpora shard too), so no unit
    crosses a shard edge and every process computes identical bounds
    reading only ~1 MB — no coordination.
    """
    size = os.path.getsize(path)
    base = -(-size // num_processes)

    def bound(i: int) -> int:
        if i <= 0:
            return 0
        target = min(size, i * base)
        if target >= size:
            return size
        with open(path, "rb") as f:
            f.seek(target)
            window = f.read(1 << 20)
        off = find_space_cut(window)
        return target + off if off >= 0 else size

    return bound(process_id), bound(process_id + 1)


def process_mesh() -> ProcessGrid:
    """1-D data grid over every rank of the world (make_mesh)."""
    return make_mesh()


class MultiHostWordEncoder:
    """Process-aware word engine: each process encodes its own bytes with a
    WordEncoder on its own card; the global id count is summed over the
    grid's data group.  Without a process group it runs as one process
    (rank 0 of 1), with no collective."""

    def __init__(self, vocab, mesh: ProcessGrid | None = None, *, device="cuda"):
        if dist.is_initialized():
            self.mesh = mesh if mesh is not None else process_mesh()
            if self.mesh.d is None:
                raise RuntimeError("this rank is outside the grid")
            if self.mesh.n_vocab != 1:
                raise ValueError("the multi-process path takes a 1-D grid (n_vocab == 1)")
            dev = rank_device(device)
        else:
            if mesh is not None:
                raise ValueError("a grid needs a process group (initialize_distributed)")
            self.mesh = None
            dev = resolve_device(device)
        self.vocab = vocab
        self._inner = WordEncoder(vocab, device=dev)
        self.last_global_total: int | None = None

    @property
    def process_index(self) -> int:
        return 0 if self.mesh is None else self.mesh.d

    @property
    def process_count(self) -> int:
        return 1 if self.mesh is None else self.mesh.n_data

    def _global_sum(self, value: int) -> int:
        if self.mesh is None:
            return int(value)
        t = torch.tensor([value], dtype=torch.int64, device=self._inner.device)
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.mesh.data_group)
        return int(t[0])

    def encode_local_bytes(self, data: bytes) -> tuple[np.ndarray, int]:
        """Encode THIS PROCESS's corpus shard.  Returns (local_ids,
        global_total_ids); the concatenation of local_ids in process
        order equals the single-process encode of the whole corpus.

        Collective contract: every process of the grid calls this the same
        number of times (the total's all_reduce is a collective); the
        shards may differ in size and content."""
        local = self._inner.encode_bytes(data)
        total = self._global_sum(local.shape[0])
        self.last_global_total = total
        return local, total

    def encode_file(self, path: str) -> tuple[np.ndarray, int]:
        """Encode this process's whitespace-safe shard of `path`."""
        start, end = file_shard_bounds(path, self.process_index, self.process_count)
        with open(path, "rb") as f:
            f.seek(start)
            data = f.read(end - start)
        return self.encode_local_bytes(data)

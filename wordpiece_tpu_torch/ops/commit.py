"""Greedy commit: turn per-position matches into the emitted id stream.

The reference's worker loop (src/fast.cpp:43-99) walks positions
sequentially: match -> advance by the match length; fail -> whole-word UNK
rollback and skip to the next word boundary.  The walk is *memoryless*
forward (the next position depends only on the current position), so the
whole batch is the orbit of a deterministic step function

    F(i) = ss[i + len_i]                    if position i matched
    F(i) = ss[wnext[min(i + window_i, n)]]  if position i failed

(`ss` skips spaces, `wnext` skips to the next word-prefix position; both
have sentinel n).  The rollback is segment-local: tokens are discarded
back to the last visited word-prefix position (tokens_since_prefix in the
reference), and a failing position always terminates its segment.

commit_with_positions_plain computes, in parallel torch ops:
 1. visited = orbit of F from every unit start, by pointer doubling
    (scatter-max and gather rounds);
 2. segments = runs of visited positions between visited word-prefix
    positions; a segment containing a failed position emits a single UNK
    at its start and suppresses its other emissions;
 3. the compacted id stream, via cumsum + scatter.

Engine-neutral: it takes matches from any matcher (the linear engine's
suffix-array sweeps, the fast-stream engine's probes).

`commit_with_positions` runs that plain version for CPU tensors and the
hand-written CUDA kernels of csrc/commit.cu (ops/commit_cuda.py:
KERNEL_LAUNCHES = 3 launches, the call counted once in
commit_with_positions.launches unless a CUDA graph's capture records
it) for CUDA tensors; never a fallback from
one to the other.  Both walk to the fixed point, as the JAX package's
while_loop does: the plain version stops on the first round that marks
nothing new, and the kernels walk each tile of positions on its own, by
pointer doubling in shared memory until a round adds nothing, with one
integer carried from tile to tile.  So the kernels equal the plain
version on every input, and no caller passes a bound on the walk.
"""

from __future__ import annotations

import torch

from . import commit_cuda


def commit(best_id, best_len, feats, n_valid: int, *, unk_id: int):
    """Returns (ids int32[n] padded with -2 beyond count, count int32)."""
    ids, _positions, count = commit_with_positions(best_id, best_len, feats, n_valid,
                                                   unk_id=unk_id)
    return ids, count


def commit_with_positions(
    best_id: torch.Tensor,  # int32[n], -1 where no match
    best_len: torch.Tensor,  # int32[n], 0 where no match
    feats,  # TextFeatures
    n_valid: int,
    *,
    unk_id: int,
):
    """commit() plus the emitting POSITION of each compacted id (used to
    attribute ids back to deduped units; positions ascend).  Returns (ids
    int32[n], positions int32[n] padded with -1, count int32 0-d tensor).

    The plain version for CPU tensors, the CUDA kernels for CUDA tensors
    (one call counted in commit_with_positions.launches)."""
    dev = best_id.device
    for name, t in (("best_len", best_len), ("window", feats.window), ("ss", feats.ss),
                    ("wnext", feats.wnext), ("space", feats.space), ("wp", feats.wp)):
        if t.device != dev:
            raise ValueError(f"best_id on {dev}, {name} on {t.device}")
    if dev.type == "cpu":
        return commit_with_positions_plain(best_id, best_len, feats, int(n_valid), unk_id=unk_id)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = commit_cuda.launch(best_id, best_len, feats, int(n_valid), unk_id=int(unk_id))
    if not torch.cuda.is_current_stream_capturing():  # a capture launches nothing
        commit_with_positions.launches += 1
    return out


commit_with_positions.launches = 0


def commit_with_positions_plain(
    best_id: torch.Tensor,
    best_len: torch.Tensor,
    feats,
    n_valid: int,
    *,
    unk_id: int,
):
    """commit_with_positions in PyTorch ops: the CPU's version, and what
    the kernels are held to on the card.  Each round of the walk reads
    one flag back to the host (one sync a round on a CUDA tensor)."""
    n = best_id.shape[0]
    dev = best_id.device
    pos = torch.arange(n, dtype=torch.int32, device=dev)

    matched = best_len > 0
    land = torch.clamp(pos + best_len, max=n)
    fail_j = torch.clamp(pos + feats.window, max=n)
    # On failure: advance past the probe window, skip to the next
    # word-prefix position, then skip spaces (src/fast.cpp:84-95).
    step = torch.where(
        matched, feats.ss[land.long()], feats.ss[feats.wnext[fail_j.long()].long()]
    )

    # Seeds: every unit start.  The walk provably visits every unit start
    # (it only ever crosses into a later unit at that unit's first
    # non-space position), so seeding all of them is exact and bounds the
    # doubling depth by log2 of the longest within-unit chain.
    prev_space = torch.cat([feats.space.new_ones(1), feats.space[:-1]])
    visited = ~feats.space & prev_space & (pos < n_valid)

    jump = step  # int32[n], values in [0, n]
    sentinel = jump.new_full((1,), n)
    commit_with_positions_plain.rounds = 0
    changed = True
    while changed:  # the JAX package's cond_fn / round_fn
        # Buffer of n + 1: unvisited positions scatter into the dropped
        # slot n.  amax makes duplicate targets well defined.
        scat = torch.zeros(n + 1, dtype=torch.int32, device=dev)
        scat.scatter_reduce_(
            0, torch.where(visited, jump, n).long(), visited.to(torch.int32), reduce="amax"
        )
        new_visited = visited | (scat[:n] > 0)
        changed = bool((new_visited != visited).any())
        visited = new_visited
        jump = torch.cat([jump, sentinel])[jump.long()]
        commit_with_positions_plain.rounds += 1

    # Segments: visited word-prefix positions start segments.
    seg_start = visited & feats.wp
    seg_id = torch.cumsum(seg_start.to(torch.int32), 0, dtype=torch.int32)  # >=1 on visited
    failed_here = visited & ~matched
    seg_killed_tab = torch.zeros(n + 2, dtype=torch.int32, device=dev)
    seg_killed_tab.scatter_reduce_(
        0,
        torch.where(failed_here, seg_id, n + 1).long(),
        failed_here.to(torch.int32),
        reduce="amax",
    )
    killed = seg_killed_tab[seg_id.long()] > 0

    emit = visited & ((matched & ~killed) | (seg_start & killed))
    emit_val = torch.where(killed, unk_id, best_id).to(torch.int32)

    out_idx = torch.cumsum(emit.to(torch.int32), 0, dtype=torch.int32) - 1
    count = (out_idx[-1] + 1) if n else torch.zeros((), dtype=torch.int32, device=dev)
    # Emitting positions have distinct slots; the rest share slot n, which
    # is sliced off.
    scatter_to = torch.where(emit, out_idx, n).long()
    ids = torch.full((n + 1,), -2, dtype=torch.int32, device=dev)
    ids.scatter_(0, scatter_to, emit_val)
    positions = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
    positions.scatter_(0, scatter_to, pos)
    return ids[:n], positions[:n], count


commit_with_positions_plain.rounds = 0  # rounds of the last call's walk

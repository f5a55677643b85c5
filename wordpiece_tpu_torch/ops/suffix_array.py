"""General suffix array + clamped LCP (the linear engine's FALLBACK path).

The reference builds its suffix array with SA-IS (libsais).  Here it is
prefix doubling: O(log n) rounds of a stable sort, with an exit as soon
as all ranks are distinct (real text separates in far fewer than log2(n)
rounds).  The exit test reads one scalar per round on the host, which is
acceptable on this path: the engine fetches the ranks to the host right
after anyway (engine_linear.LinearEncoder._encode_batch_doubling).

The PRODUCTION linear path does not need a true suffix array at all: its
sweeps observe LCP only clamped at max_len, so nk radix passes over
packed k-gram keys suffice (engine_linear._linear_batch_core).  This
module remains for vocabularies whose alphabet x token length
degenerates the packed keys.

LCP: the monotone-stack sweeps only ever compare LCP values against token
lengths <= max_len, so LCP clamped at max_len is sufficient.  That turns
the LCP array into max_len vectorized character comparisons — no Kasai
sequential pass.
"""

from __future__ import annotations

import torch


def _ranks_of_sorted(key_sorted: torch.Tensor) -> torch.Tensor:
    """Dense ranks (0-based) of a sorted key vector: equal keys share one."""
    new_group = torch.cat(
        [key_sorted.new_zeros(1, dtype=torch.int32), (key_sorted[1:] != key_sorted[:-1]).int()]
    )
    return torch.cumsum(new_group, 0, dtype=torch.int32)


def suffix_array(s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Prefix-doubling SA with early exit.

    Args: s int32[n] (values >= 0).
    Returns (sa int32[n], rank int32[n]).

    Each round sorts the pair (rank, rank at +shift) as ONE int64 key,
    rank * (base) + second + 1, which orders exactly as the two-key sort;
    the sort is stable, so equal pairs keep index order."""
    n = s.shape[0]
    dev = s.device
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    if n == 0:
        return idx, idx.clone()

    # Initial ranks over the first TWO symbols (one sort replaces the
    # single-symbol sort plus the shift=1 doubling round).
    s64 = s.long()
    s2 = torch.cat([s64[1:], s64.new_full((1,), -1)])
    base = int(s64.max()) + 2
    key, order = torch.sort(s64 * base + (s2 + 1), stable=True)
    ranks_sorted = _ranks_of_sorted(key)
    rank = torch.zeros(n, dtype=torch.int32, device=dev).scatter_(0, order, ranks_sorted)

    shift = 2
    done = n <= 1 or int(ranks_sorted[-1]) == n - 1
    while not done and shift < n:
        ahead = torch.clamp(idx + shift, max=n - 1).long()
        rank2 = torch.where(idx + shift < n, rank[ahead], -1)
        key, order = torch.sort(rank.long() * (n + 1) + (rank2.long() + 1), stable=True)
        ranks_sorted = _ranks_of_sorted(key)
        rank = torch.zeros(n, dtype=torch.int32, device=dev).scatter_(0, order, ranks_sorted)
        done = int(ranks_sorted[-1]) == n - 1  # all distinct
        shift *= 2
    sa = torch.zeros(n, dtype=torch.int32, device=dev).scatter_(0, rank.long(), idx)
    return sa, rank


def lcp_clamped(s: torch.Tensor, sa: torch.Tensor, *, clamp: int) -> torch.Tensor:
    """lcp[r] = min(clamp, LCP(suffix sa[r], suffix sa[r+1])); last 0.

    Direct comparison: `clamp` vectorized rounds, each comparing the
    next character of every adjacent suffix pair."""
    n = sa.shape[0]
    a = sa
    b = torch.cat([sa[1:], sa.new_full((1,), n - 1)])
    alive = torch.arange(n, device=sa.device) < n - 1
    lcp = torch.zeros(n, dtype=torch.int32, device=sa.device)
    for j in range(clamp):
        ok = alive & (a + j < n) & (b + j < n)
        ca = s[torch.clamp(a + j, max=n - 1).long()]
        cb = s[torch.clamp(b + j, max=n - 1).long()]
        ok = ok & (ca == cb)
        lcp = lcp + ok.int()
        alive = ok
    return lcp

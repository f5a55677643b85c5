"""Linear-engine matching: surviving-token-slot scans over SA order.

The reference's get_closest (src/linear.cpp:161-213) walks the suffix
array with a monotone stack: a vocab token (pushed at its suffix's SA
position) survives while the running LCP minimum stays >= its length;
the stack top at each position is the longest vocab token that prefixes
that suffix.  Since surviving tokens are nested prefixes of the current
suffix, the stack is at most max_len deep and is representable as a
fixed array of slots indexed BY LENGTH — and each length's slot has a
closed form over running maxima (see surviving_push), so the whole
sequential stack walk becomes batched cummax passes.

Four scans (left/right x prefix/suffix kind) as in the reference; the
union of the four slot sets gives, per SA position, ALL vocab tokens
matching there, so the engine can apply the probe-window cap exactly and
reproduce the Fast engine's (canonical) semantics even for vocab tokens
containing interior spacing characters — a case where the reference's
linear algorithm would silently diverge from its fast one (no window
check in match_word_piece, src/linear.cpp:221-274).

Slots carry PUSH POSITIONS, not token ids: positions ARE the cummax
values, so the id gather waits until after the per-text-position length
selection — one gather per text position per kind.  The kill scan
depends only on the LCP edges, so it is computed once per direction and
shared by both kinds.

`match_from_sa` runs the plain version, match_from_sa_plain (these torch
ops, [max_len, n] matrices and all), for CPU tensors and the hand-written
CUDA kernels of csrc/linear_match.cu (ops/linear_match_cuda.py:
KERNEL_LAUNCHES = 3 launches and no memset, the call counted once in
match_from_sa.launches unless a CUDA graph's capture records it) for
CUDA tensors; never a fallback from one to the
other.  The kernels hold the slots' other form: at each rank the set of
lengths whose slot is alive, a bitset of at most three words a kind in a
thread's registers (kill the lengths above the entering edge, then set
the push's), scanned over lanes, warps and tiles by its run summary, and
the latest push per (kind, length) found only for the length a text
position takes.  They write no [max_len, n] buffer.
"""

from __future__ import annotations

import torch

from . import linear_match_cuda


def _lens(max_len: int, device) -> torch.Tensor:
    return torch.arange(1, max_len + 1, dtype=torch.int32, device=device)


def surviving_push(
    lcp_edge: torch.Tensor,  # int32[n]: LCP between position p-1 and p (p=0 -> big)
    push_len: torch.Tensor,  # int32[n]: token length pushed at p (0 = none)
    lastkill: torch.Tensor,  # int32[max_len, n]: latest r <= p with lcp_edge[r] < l
    *,
    max_len: int,
) -> torch.Tensor:
    """Inclusive monotone-stack scan; returns push positions
    int32[max_len, n] (-1 where no surviving push).

    out[l-1, p] = the LATEST position q <= p that pushed a token of
    length l and still survives at p.  Survival means every edge strictly
    after q up to p has LCP >= l (the stack-filter condition);
    equivalently q >= lastkill_l[p], where lastkill_l[p] is the latest
    position r <= p whose entering edge has lcp_edge[r] < l (the edge at
    r sits BEFORE r's own push, so a push at r survives its own edge).
    """
    n = lcp_edge.shape[0]
    pos = torch.arange(n, dtype=torch.int32, device=lcp_edge.device)
    lens = _lens(max_len, lcp_edge.device)

    # lastpush[l-1, p]: latest q <= p with push_len[q] == l (-1 if none).
    ppos = torch.where(push_len[None, :] == lens[:, None], pos[None, :], -1)
    lastpush = torch.cummax(ppos, dim=1).values
    alive = (lastpush >= 0) & (lastpush >= lastkill)
    return torch.where(alive, lastpush, -1)


def _lastkill(lcp_edge: torch.Tensor, *, max_len: int) -> torch.Tensor:
    """int32[max_len, n]: latest r <= p with lcp_edge[r] < l (0 if none;
    a kill at r=0 is vacuous — no pushes precede position 0).  Depends
    only on the edges: shared by both kinds of one direction."""
    n = lcp_edge.shape[0]
    pos = torch.arange(n, dtype=torch.int32, device=lcp_edge.device)
    lens = _lens(max_len, lcp_edge.device)
    kpos = torch.where(lcp_edge[None, :] < lens[:, None], pos[None, :], 0)
    return torch.cummax(kpos, dim=1).values


def match_from_sa(
    rank: torch.Tensor,  # int32[n_s]: SA rank of every S position
    lcp: torch.Tensor,  # int32[n_s]: lcp[r] between sa[r], sa[r+1]
    who_len: torch.Tensor,  # int32[n_s]: at SA rank r, eligible token len (0 none)
    who_id: torch.Tensor,  # int32[n_s]
    who_kind: torch.Tensor,  # int32[n_s]: 1 prefix, 0 suffix (-1 none)
    window: torch.Tensor,  # int32[n_text]
    wp: torch.Tensor,  # bool[n_text]
    *,
    max_len: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (best_id, best_len) per text position (canonical window-capped
    longest match), computed from the suffix array: the plain version for
    CPU tensors, the CUDA kernels for CUDA tensors (one call counted in
    match_from_sa.launches; they take rank as a permutation and n_text <=
    n_s, as every caller passes)."""
    dev = rank.device
    for name, t in (("lcp", lcp), ("who_len", who_len), ("who_id", who_id),
                    ("who_kind", who_kind), ("window", window), ("wp", wp)):
        if t.device != dev:
            raise ValueError(f"rank on {dev}, {name} on {t.device}")
    if dev.type == "cpu":
        return match_from_sa_plain(rank, lcp, who_len, who_id, who_kind, window, wp,
                                   max_len=max_len)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = linear_match_cuda.launch(rank, lcp, who_len, who_id, who_kind, window, wp,
                                   max_len=int(max_len))
    if not torch.cuda.is_current_stream_capturing():  # a capture launches nothing
        match_from_sa.launches += 1
    return out


match_from_sa.launches = 0


def match_from_sa_plain(
    rank: torch.Tensor,  # int32[n_s]: SA rank of every S position
    lcp: torch.Tensor,  # int32[n_s]: lcp[r] between sa[r], sa[r+1]
    who_len: torch.Tensor,  # int32[n_s]: at SA rank r, eligible token len (0 none)
    who_id: torch.Tensor,  # int32[n_s]
    who_kind: torch.Tensor,  # int32[n_s]: 1 prefix, 0 suffix (-1 none)
    window: torch.Tensor,  # int32[n_text]
    wp: torch.Tensor,  # bool[n_text]
    *,
    max_len: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """match_from_sa in PyTorch ops: the CPU's version, and what the
    kernels are held to on the card."""
    n_s = rank.shape[0]
    n_text = window.shape[0]
    dev = rank.device
    big = 1 << 30

    # Edges: left-sweep edge entering rank r is lcp[r-1] (big at r=0);
    # right-sweep (descending r) edge entering r is lcp[r] (big at n-1).
    lcp_left = torch.cat([lcp.new_full((1,), big), lcp[:-1]])
    lcp_rev = torch.cat([lcp.new_full((1,), big), torch.flip(lcp, [0])[1:]])
    kill_left = _lastkill(lcp_left, max_len=max_len)
    kill_rev = _lastkill(lcp_rev, max_len=max_len)

    pos = torch.arange(n_text, dtype=torch.int64, device=dev)
    r_text = rank[torch.clamp(pos, max=n_s - 1)].long()  # SA rank per text suffix
    lens = _lens(max_len, dev)
    last = n_s - 1

    def best_of(kind: int):
        plen = torch.where(who_kind == kind, who_len, 0)
        # Push positions surviving at each rank, [max_len, n_s]; the
        # right sweep runs in reversed coordinates and converts back.
        left_q = surviving_push(lcp_left, plen, kill_left, max_len=max_len)
        right_qr = surviving_push(
            lcp_rev, torch.flip(plen, [0]), kill_rev, max_len=max_len
        )
        # Per text position: its rank's slots, [n_text, max_len].
        sl = left_q[:, r_text].T
        sr_r = right_qr[:, last - r_text].T
        sr = torch.where(sr_r >= 0, last - sr_r, -1)  # reversed -> true rank
        merged_q = torch.where(sr >= 0, sr, sl)
        ok = (merged_q >= 0) & (lens[None, :] <= window[:, None])
        best_l = torch.where(ok, lens[None, :], 0).amax(dim=1)
        take = (lens[None, :] == best_l[:, None]) & ok
        best_q = torch.where(take, merged_q, -1).amax(dim=1)
        # ONE id gather per text position, after selection.
        best_i = torch.where(best_q >= 0, who_id[torch.clamp(best_q, min=0).long()], -1)
        return best_i, best_l

    id_p, len_p = best_of(1)
    id_s, len_s = best_of(0)
    return torch.where(wp, id_p, id_s), torch.where(wp, len_p, len_s)

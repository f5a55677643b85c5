"""Plain PyTorch version of the word match+commit kernel.

Rows are independent units (see engine_word.py for why).  For each unit
of `width` codepoints this computes, with whole-tensor ops only:

 - char classes and the probe window per position;
 - the longest in-window vocabulary hit per position: two 32-bit rolling
   hashes per length l probe the B_l candidate rows of the lane-bucketed
   length tables (core/length_tables.py) at a hashed lane;
 - the greedy walk from position 0 and the whole-word UNK rollback;
 - the emit matrix: a token id per emitting position, -2 elsewhere.

It is the reference that csrc/word_kernel.cu is held against, and what
ops/word_kernel_cuda.py runs for tensors on the CPU.  The arithmetic
mirrors wordpiece_tpu/ops/word_kernel.py; PyTorch has no full uint32
arithmetic, so the hashes are kept in int64 and wrapped to 32 bits with
`& 0xFFFFFFFF` (multiplies are split in 16-bit halves so that no int64
product overflows).  The tables hold uint32 bits in int32; they are
compared in the same unsigned int64 view.
"""

from __future__ import annotations

import torch

from ..core.length_tables import KIND_MIX, LEN_MIX
from . import text_features as tf

MASK32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, m: int) -> torch.Tensor:
    """(a * m) mod 2^32 for int64 `a` in [0, 2^32) and a Python int `m`."""
    m &= MASK32
    lo = a * (m & 0xFFFF)
    hi = (a * (m >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & MASK32


def _suffix_min(v: torch.Tensor) -> torch.Tensor:
    """Row-local suffix minimum along dim 1."""
    return torch.flip(torch.cummin(torch.flip(v, (1,)), dim=1).values, (1,))


def _widen(cp: torch.Tensor, width: int, max_len: int) -> torch.Tensor:
    """Any-integer [U, >= width] unit matrix -> int64 [U, width + max_len].
    Columns >= width read as space (32), whatever the input holds there."""
    if cp.dim() != 2 or cp.shape[1] < width:
        raise ValueError(f"expected a [U, >= {width}] unit matrix, got {tuple(cp.shape)}")
    out = torch.full(
        (cp.shape[0], width + max_len), 32, dtype=torch.int64, device=cp.device
    )
    out[:, :width] = cp[:, :width].to(torch.int64)
    return out


def _features(cp: torch.Tensor, width: int, max_len: int):
    """Row-local features shared by match and commit: (pos, space, punct,
    wp word-prefix mask, probe window)."""
    U = cp.shape[0]
    W = width
    cp_w = cp[:, :W]
    pos = torch.arange(W, dtype=torch.int64, device=cp.device).expand(U, W)

    space = tf.is_space(cp_w)
    punct = tf.is_punct(cp_w)
    spacing = space | punct | tf.is_chinese(cp_w)

    ones = torch.ones((U, 1), dtype=torch.bool, device=cp.device)
    prev_spacing = torch.cat([ones, spacing[:, :-1]], dim=1)
    wp = spacing | prev_spacing  # col 0 is always a word prefix (unit start)

    # Probe window (src/fast.cpp:53-60): distance to the first spacing
    # char strictly after j; pads are spaces so the unit end binds.
    spc_pos = torch.where(spacing, pos, W)
    nsp_at = _suffix_min(spc_pos)
    fill = torch.full((U, 1), W, dtype=torch.int64, device=cp.device)
    nsp_after = torch.cat([nsp_at[:, 1:], fill], dim=1)
    window = torch.clamp(nsp_after - pos, max=max_len)
    window = torch.minimum(window, W - pos)
    window = torch.where(punct, 1, window)
    window = torch.clamp(window, min=1)
    return pos, space, punct, wp, window


def word_match(
    cp: torch.Tensor,  # integer [U, >= width]; columns >= width read as space
    tab_k1: torch.Tensor,  # int32[R, 128]
    tab_k2: torch.Tensor,  # int32[R, 128]
    tab_id: torch.Tensor,  # int32[R, 128]
    *,
    width: int,
    max_len: int,
    rows_off: tuple,
    mult1: int,
    mult2: int,
    lane_salts: tuple,
):
    """Longest-match probe phase: (best_id, best_len) int64[U, width]."""
    cp = _widen(cp, width, max_len)
    U = cp.shape[0]
    W = width
    _, _, _, wp, window = _features(cp, width, max_len)

    kind = wp.to(torch.int64)
    h1 = torch.zeros((U, W), dtype=torch.int64, device=cp.device)
    h2 = torch.zeros((U, W), dtype=torch.int64, device=cp.device)
    best_id = torch.full((U, W), -1, dtype=torch.int64, device=cp.device)
    best_len = torch.zeros((U, W), dtype=torch.int64, device=cp.device)

    for l in range(1, max_len + 1):
        c = cp[:, l - 1 : l - 1 + W]
        h1 = (_mul32(h1, mult1) + c) & MASK32
        h2 = (_mul32(h2, mult2) + c) & MASK32
        r0, r1 = rows_off[l], rows_off[l + 1]
        if r1 == r0:
            continue
        len_mix = (LEN_MIX * l) & MASK32
        key2 = h2 ^ len_mix ^ (kind * KIND_MIX)
        mixed = h1 ^ ((h2 << 1) & MASK32) ^ len_mix ^ (kind * KIND_MIX)
        lane = (_mul32(mixed, lane_salts[l] | 1) >> (32 - 7)).reshape(-1)
        ok_l = (window >= l).reshape(-1)

        # All B_l candidate rows at once: [B_l, U*W] per table.
        cand1 = (tab_k1[r0:r1].to(torch.int64) & MASK32)[:, lane]
        cand2 = (tab_k2[r0:r1].to(torch.int64) & MASK32)[:, lane]
        candi = tab_id[r0:r1].to(torch.int64)[:, lane]
        hit = (
            (cand1 == h1.reshape(1, -1))
            & (cand2 == key2.reshape(1, -1))
            & (candi >= 0)
            & ok_l[None, :]
        )
        # Last hitting row wins, as in a sequential row scan.
        ks = torch.arange(r1 - r0, device=cp.device)[:, None]
        last = torch.where(hit, ks, -1).amax(dim=0)
        any_hit = (last >= 0).reshape(U, W)
        cid = candi.gather(0, last.clamp(min=0)[None, :])[0].reshape(U, W)
        best_id = torch.where(any_hit, cid, best_id)
        best_len = torch.where(any_hit, l, best_len)
    return best_id, best_len


def word_commit(
    cp: torch.Tensor,
    best_id: torch.Tensor,
    best_len: torch.Tensor,
    *,
    width: int,
    max_len: int,
    unk_id: int,
) -> torch.Tensor:
    """Greedy walk + whole-word UNK rollback over the match results."""
    cp = _widen(cp, width, max_len)
    U = cp.shape[0]
    W = width
    dev = cp.device
    pos, space, _, wp, window = _features(cp, width, max_len)
    best_id = best_id.to(torch.int64)
    best_len = best_len.to(torch.int64)

    matched = best_len > 0

    # Next-position helpers with sentinel column W.
    fill_w = torch.full((U, 1), W, dtype=torch.int64, device=dev)
    ss_ext = torch.cat([_suffix_min(torch.where(~space, pos, W)), fill_w], dim=1)
    wp_ext = torch.cat([_suffix_min(torch.where(wp, pos, W)), fill_w], dim=1)

    land = torch.clamp(pos + best_len, max=W)
    failj = torch.clamp(pos + window, max=W)
    step_match = ss_ext.gather(1, land)
    step_fail = ss_ext.gather(1, wp_ext.gather(1, failj))
    step = torch.where(matched, step_match, step_fail)
    jump = torch.cat([step, fill_w], dim=1)  # (U, W+1)

    pos_ext = torch.arange(W + 1, dtype=torch.int64, device=dev).expand(U, W + 1)
    p = torch.zeros((U, 1), dtype=torch.int64, device=dev)
    visited = torch.zeros((U, W + 1), dtype=torch.bool, device=dev)
    # The walk advances >= 1 per step, so <= W+1 steps reach the sentinel.
    for _ in range(W + 1):
        visited |= pos_ext == p
        p = jump.gather(1, p)
    visited = visited[:, :W]

    # Segment kill: a visited fail position kills every emission back to
    # its segment start (last visited word-prefix position), which then
    # emits a single UNK.
    seg_start = visited & wp
    fail_here = visited & ~matched
    next_fail = _suffix_min(torch.where(fail_here, pos, W + 1))
    seg_pos = torch.where(seg_start, pos, W + 1)
    fill_w1 = torch.full((U, 1), W + 1, dtype=torch.int64, device=dev)
    next_seg_after = torch.cat([_suffix_min(seg_pos)[:, 1:], fill_w1], dim=1)
    # Strict <: a fail that IS the next segment start belongs to that later
    # segment and must not kill this one.
    killed = visited & (next_fail < next_seg_after)

    emit = visited & ((matched & ~killed) | (seg_start & killed))
    # Empty (all-space pad) rows emit nothing (real units never start
    # with a space).
    emit = emit & ~space[:, :1]
    emit_val = torch.where(killed, unk_id, best_id)
    return torch.where(emit, emit_val, -2).to(torch.int32)


def word_match_commit(
    cp: torch.Tensor,  # integer [U, >= width]; columns >= width read as space
    tab_k1: torch.Tensor,  # int32[R, 128]
    tab_k2: torch.Tensor,  # int32[R, 128]
    tab_id: torch.Tensor,  # int32[R, 128]
    *,
    width: int,
    max_len: int,
    rows_off: tuple,
    mult1: int,
    mult2: int,
    lane_salts: tuple,
    unk_id: int,
) -> torch.Tensor:
    """Returns emit int32[U, width]: token id per emitting position, -2
    where nothing is emitted."""
    if cp.shape[0] == 0:
        return torch.full((0, width), -2, dtype=torch.int32, device=cp.device)
    best_id, best_len = word_match(
        cp,
        tab_k1,
        tab_k2,
        tab_id,
        width=width,
        max_len=max_len,
        rows_off=rows_off,
        mult1=mult1,
        mult2=mult2,
        lane_salts=lane_salts,
    )
    return word_commit(
        cp, best_id, best_len, width=width, max_len=max_len, unk_id=unk_id
    )

"""The port's suffix-array sweeps (ops/linear_match.py: surviving_push,
_lastkill, match_from_sa) against the JAX package's, on the same
numpy-seeded suffix arrays and on bench/linear_cases.py's edge cases of
the CUDA kernels (csrc/linear_match.cu), where a numpy model of those
kernels (the bitset of surviving lengths, its summary operator over
lanes, warps and tiles, the push rows and the carries) is held to the
JAX package and, with one rank a tile, to a sequential stack walk; the
operator's laws; and the dispatcher's refusals.  Integers: exact."""

import bisect
import functools
import re
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wordpiece_tpu.ops import linear_match as jlm
from wordpiece_tpu_torch.bench import linear_cases
from wordpiece_tpu_torch.engine_linear import LinearEncoder
from wordpiece_tpu_torch.ops import linear_match as lm
from wordpiece_tpu_torch.ops import linear_match_cuda as lcu
from wordpiece_tpu_torch.ops.suffix_array import lcp_clamped, suffix_array

torch.set_num_threads(1)


def edges_and_pushes(seed: int, n: int, max_len: int):
    rng = np.random.default_rng(seed)
    lcp_edge = rng.integers(0, max_len + 2, size=n).astype(np.int32)
    lcp_edge[0] = 1 << 30
    push_len = np.where(rng.random(n) < 0.4, rng.integers(1, max_len + 1, size=n), 0)
    return lcp_edge, push_len.astype(np.int32)


@pytest.mark.parametrize("seed,n,max_len", [(0, 64, 4), (1, 300, 9)])
def test_lastkill_and_surviving_push_equal_jax(seed, n, max_len):
    lcp_edge, push_len = edges_and_pushes(seed, n, max_len)
    kill = lm._lastkill(torch.from_numpy(lcp_edge), max_len=max_len)
    jkill = jlm._lastkill(jnp.asarray(lcp_edge), max_len=max_len)
    np.testing.assert_array_equal(kill.numpy(), np.asarray(jkill))
    got = lm.surviving_push(
        torch.from_numpy(lcp_edge), torch.from_numpy(push_len), kill, max_len=max_len
    )
    want = jlm.surviving_push(
        jnp.asarray(lcp_edge), jnp.asarray(push_len), jkill, max_len=max_len
    )
    assert got.dtype == torch.int32 and got.shape == (max_len, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def sa_instance(seed: int, n_text: int, n_tok: int, max_len: int):
    """The reference's S = text · -1 · tok_1 · -1 · … over a small alphabet,
    its suffix array and clamped LCP, and the who-tables at the token
    start ranks."""
    rng = np.random.default_rng(seed)
    text = rng.choice(np.array([97, 98, 99, 32], dtype=np.int32), size=n_text)
    toks = [rng.integers(97, 100, size=int(rng.integers(1, max_len + 1))) for _ in range(n_tok)]
    parts, starts, pos = [text, np.array([-1])], [], n_text + 1
    for t in toks:
        starts.append(pos)
        parts += [t, np.array([-1])]
        pos += t.shape[0] + 1
    s = np.concatenate(parts).astype(np.int32)
    s = np.concatenate([s, 0x110001 + np.arange(512 - s.shape[0])]).astype(np.int32)
    sa, rank = suffix_array(torch.from_numpy(s))
    lcp = lcp_clamped(torch.from_numpy(s), sa, clamp=max_len)
    r = rank.numpy()[np.array(starts)]
    who_len = np.zeros(s.shape[0], np.int32)
    who_id = np.full(s.shape[0], -1, np.int32)
    who_kind = np.full(s.shape[0], -1, np.int32)
    who_len[r] = [t.shape[0] for t in toks]
    who_id[r] = np.arange(n_tok)
    who_kind[r] = rng.integers(0, 2, size=n_tok)
    window = np.maximum(1, rng.integers(0, max_len + 1, size=n_text)).astype(np.int32)
    wp = rng.random(n_text) < 0.4
    return rank.numpy(), lcp.numpy(), who_len, who_id, who_kind, window, wp


@pytest.mark.parametrize("seed,n_text,n_tok,max_len", [(0, 128, 20, 3), (1, 256, 40, 6)])
def test_match_from_sa_equals_jax(seed, n_text, n_tok, max_len):
    rank, lcp, who_len, who_id, who_kind, window, wp = sa_instance(seed, n_text, n_tok, max_len)
    t = torch.from_numpy
    got_id, got_len = lm.match_from_sa(
        t(rank), t(lcp), t(who_len), t(who_id), t(who_kind), t(window), t(wp), max_len=max_len
    )
    run = jax.jit(partial(jlm.match_from_sa, max_len=max_len), static_argnums=5)
    want_id, want_len = run(
        jnp.asarray(rank), jnp.asarray(lcp), jnp.asarray(who_len), jnp.asarray(who_id),
        jnp.asarray(who_kind), n_text, jnp.asarray(window), jnp.asarray(wp),
    )
    assert (got_len.numpy() > 0).sum() > n_text // 4  # the instance matches often
    np.testing.assert_array_equal(got_id.numpy(), np.asarray(want_id))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))


# ---- the edge cases of the CUDA kernels (bench/linear_cases.py) ---------------------
CASES = linear_cases.cases()
FIELDS = linear_cases.FIELDS


@functools.lru_cache(maxsize=None)
def jax_match(name: str):
    c = CASES[name]
    run = jax.jit(partial(jlm.match_from_sa, max_len=c["max_len"]), static_argnums=5)
    args = [jnp.asarray(c[k]) for k in FIELDS]
    out = run(*args[:5], int(c["window"].shape[0]), *args[5:])
    return tuple(np.asarray(o) for o in out)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_equals_jax_on_kernel_cases(name):
    """Tokens at rank 0 and at the last rank, edge runs over three tiles,
    windows of 0 and past max_len, both kinds at one string, n_text < n_s
    with pad positions, max_len 1, 16, 33 and 96, the main path's and the
    fallback's layouts: the plain match_from_sa equals the JAX package."""
    c = CASES[name]
    got_id, got_len = lm.match_from_sa(*(torch.from_numpy(c[k]) for k in FIELDS),
                                       max_len=c["max_len"])
    want_id, want_len = jax_match(name)
    assert got_id.dtype == got_len.dtype == torch.int32
    np.testing.assert_array_equal(got_id.numpy(), want_id)
    np.testing.assert_array_equal(got_len.numpy(), want_len)


EDGE_NONE = 255  # kEdgeNone of csrc/linear_match.cu: a clamped edge kills no length


def low(e, words: int) -> np.ndarray:
    """low(e) word by word, uint32[..., words]: the lengths 1..e, bit
    (l - 1) % 32 of word (l - 1) // 32 for length l."""
    n = np.asarray(e, np.int64)[..., None] - 32 * np.arange(words)
    return np.where(n >= 32, 0xFFFFFFFF, (1 << np.clip(n, 0, 31)) - 1).astype(np.uint32)


def identity(shape: tuple, words: int):
    """The operator's identity: (kEdgeNone, none, none)."""
    return np.full(shape, EDGE_NONE, np.int64), np.zeros((*shape, 2, words), np.uint32)


def combine(a, b):
    """Run a then run b, each (E int[...], M uint32[..., kind, word])."""
    (ea, ma), (eb, mb) = a, b
    return np.minimum(ea, eb), (ma & low(eb, ma.shape[-1])[..., None, :]) | mb


def apply(sets, run):
    """The sets uint32[..., kind, word] after the run."""
    e, m = run
    return (sets & low(e, sets.shape[-1])[..., None, :]) | m


def high_bit(x) -> np.ndarray:
    """Index of the highest set bit of each 32-bit x, -1 for 0."""
    x = np.asarray(x, np.int64)
    out = np.full(x.shape, -1)
    for i in range(32):
        out = np.where((x >> i) & 1, i, out)
    return out


def low_bit(x) -> np.ndarray:
    """Index of the lowest set bit of each 32-bit x, -1 for 0."""
    x = np.asarray(x, np.int64)
    out = np.full(x.shape, -1)
    for i in reversed(range(32)):
        out = np.where((x >> i) & 1, i, out)
    return out


def lane_scan(run, d: int):
    """Inclusive scan of runs over their last lane axis (E [..., lanes], M
    [..., lanes, kind, word]) as the kernels' shuffles do it: lane 0 first
    in the left sweep (d 0, shfl_up), the last lane first in the right."""
    e, m = run
    lanes = e.shape[-1]
    lane = np.arange(lanes)
    step = 1
    while step < lanes:
        shift = step if d == 0 else -step
        other = np.roll(e, shift, axis=-1), np.roll(m, shift, axis=-3)
        valid = lane >= step if d == 0 else lane + step < lanes
        ce, cm = combine(other, (e, m))
        e, m = np.where(valid, ce, e), np.where(valid[:, None, None], cm, m)
        step *= 2
    return e, m


def exclusive(run, d: int):
    """The kernels' `exclusive`: n <= 32 items on lanes 0..n-1, the lanes
    past them the identity, the inclusive scan, then each lane takes its
    neighbour's (shfl_up by one and lane 0 the identity in the left sweep;
    shfl_down by one in the right, the last lane keeping its own)."""
    e, m = run
    n = e.shape[-1]
    pad_e, pad_m = identity((*e.shape[:-1], 32 - n), m.shape[-1])
    e, m = lane_scan((np.concatenate([e, pad_e], -1), np.concatenate([m, pad_m], -3)), d)
    if d == 0:
        e = np.concatenate([np.full_like(e[..., :1], EDGE_NONE), e[..., :-1]], -1)
        m = np.concatenate([np.zeros_like(m[..., :1, :, :]), m[..., :-1, :, :]], -3)
    else:
        e = np.concatenate([e[..., 1:], e[..., -1:]], -1)
        m = np.concatenate([m[..., 1:, :, :], m[..., -1:, :, :]], -3)
    return e[..., :n], m[..., :n, :, :]


CARRY_THREADS = 1024  # kCarryThreads: a summary carry block's segments


def kernel_model(c: dict, tile: int = lcu.TILE, segs: int = 32):
    """csrc/linear_match.cu in numpy, kernel by kernel, at `tile` ranks a
    block (one a lane, 32 lanes a warp; `tile` 1 makes every rank a tile of
    its own) and `segs` carry segments:
     - tiles: the inverse map from every position t < n_s; each rank's
       one-rank run (its edge, its push bit); the warp scans in each
       sweep's order as shuffles do it; the push bit rows (a word a warp,
       what each group leader of __match_any_sync writes); each tile's
       summary (warp 0's scan of its warps) and latest pushes (the rows'
       highest and lowest bits);
     - carry: the summaries by the operator (a segment of tiles for each
       of CARRY_THREADS threads, the warp scan, warp 0's scan of the
       warps) and the pushes by max (`segs` segments), in each sweep's
       order, into exclusive carries;
     - walk: the sets entering each warp (warp 0: the carry, then its
       exclusive scan of the warps), each rank's after its own step (the
       warp scan), L_left and L_right under the window, and q for the
       winning sweep from the bit rows, the rows' word masks or the carry;
       the right sweep wins ties."""
    rank, lcp, who_len, who_id, who_kind, window, wp = (c[k].astype(np.int64) for k in FIELDS)
    ml = c["max_len"]
    words = -(-ml // 32)
    n_s, n_text, last = rank.shape[0], window.shape[0], rank.shape[0] - 1
    lanes = min(32, tile)
    warps = tile // lanes
    tiles = -(-n_s // tile)
    n_pad = tiles * tile
    rows = 2 * ml

    edge = np.full((2, n_pad), EDGE_NONE)
    edge[0, 1:n_s] = np.clip(lcp[: n_s - 1], 0, EDGE_NONE)
    edge[1, : n_s - 1] = np.clip(lcp[: n_s - 1], 0, EDGE_NONE)
    ok = np.isin(who_kind, (0, 1)) & (who_len >= 1) & (who_len <= ml)
    plen, pkind = np.zeros(n_pad, np.int64), np.zeros(n_pad, np.int64)
    plen[:n_s], pkind[:n_s] = np.where(ok, who_len, 0), np.where(ok, who_kind, 0)

    # ---- tiles kernel
    t = np.arange(n_s)
    text_t = np.full(n_pad, -1)
    text_t[rank] = np.where(t < n_text, t, -1)
    text_w, text_k = np.zeros(n_pad, np.int64), np.zeros(n_pad, np.int64)
    text_w[rank[:n_text]] = np.clip(window, 0, ml)
    text_k[rank[:n_text]] = wp

    pushes = np.flatnonzero(plen)
    one = np.zeros((n_pad, 2, words), np.uint32)
    b = plen[pushes] - 1
    one[pushes, pkind[pushes], b // 32] = (1 << (b % 32)).astype(np.uint32)
    shape = (tiles, warps, lanes)

    scans = [lane_scan((edge[d].reshape(shape), one.reshape(*shape, 2, words)), d)
             for d in range(2)]
    ends = [-1, 0]  # the lane holding a scan's whole run, by sweep
    warp_sum = [(scans[d][0][:, :, ends[d]], scans[d][1][:, :, ends[d]]) for d in range(2)]

    bits = np.zeros((tiles, warps, rows), np.int64)
    np.bitwise_or.at(bits, (pushes // tile, pushes % tile // lanes,
                            pkind[pushes] * ml + plen[pushes] - 1), 1 << (pushes % lanes))
    tile0 = np.arange(tiles)[:, None] * tile
    hi = np.max([np.where(bits[:, w] > 0, w * lanes + high_bit(bits[:, w]), -1)
                 for w in range(warps)], axis=0)
    lo = np.min([np.where(bits[:, w] > 0, w * lanes + low_bit(bits[:, w]), tile)
                 for w in range(warps)], axis=0)
    agg_push = [np.where(hi >= 0, tile0 + hi, -1), np.where(lo < tile, last - (tile0 + lo), -1)]
    agg_sum = []
    for d in range(2):  # warp 0: the warps' summaries on its lanes, the identity past them
        pad_e, pad_m = identity((tiles, 32 - warps), words)
        e, m = lane_scan((np.concatenate([warp_sum[d][0], pad_e], 1),
                          np.concatenate([warp_sum[d][1], pad_m], 1)), d)
        agg_sum.append((e[:, ends[d]], m[:, ends[d]]))

    # ---- carry kernel
    carry_m, carry_push = [], []
    for d in range(2):
        order = np.arange(tiles) if d == 0 else np.arange(tiles)[::-1]
        # Blocks 0 and 1: the summaries, a segment of tiles a thread.
        per = -(-tiles // CARRY_THREADS)
        parts = [order[a : a + per] for a in range(0, CARRY_THREADS * per, per)]
        seg_e, seg_m = identity((CARRY_THREADS,), words)
        for j, part in enumerate(parts):
            for i in part:
                seg_e[j], seg_m[j] = combine((seg_e[j], seg_m[j]),
                                             (agg_sum[d][0][i], agg_sum[d][1][i]))
        seg = seg_e.reshape(32, 32), seg_m.reshape(32, 32, 2, words)  # [warp, lane]
        before = exclusive(seg, 0)
        incl = combine(before, seg)
        warp_before = exclusive((incl[0][:, 31], incl[1][:, 31]), 0)
        run_e, run_m = combine((warp_before[0][:, None], warp_before[1][:, None]), before)
        run_e, run_m = run_e.ravel(), run_m.reshape(CARRY_THREADS, 2, words)
        cm = np.zeros((tiles, 2, words), np.uint32)
        for j, part in enumerate(parts):
            run = run_e[j], run_m[j]
            for i in part:
                cm[i] = run[1]
                run = combine(run, (agg_sum[d][0][i], agg_sum[d][1][i]))
        carry_m.append(cm)
        # The later blocks: the pushes by max, `segs` segments, seeded -1.
        per = -(-tiles // segs)
        segments = [order[a : a + per] for a in range(0, tiles, per)]
        cp = np.full((tiles, rows), -1)
        for j, part in enumerate(segments):
            top = np.max([agg_push[d][p].max(axis=0) for p in segments[:j]] + [np.full(rows, -1)],
                         axis=0)
            for i in part:
                cp[i] = top
                top = np.maximum(top, agg_push[d][i])
        carry_push.append(cp)

    # ---- walk kernel
    sets = []
    for d in range(2):
        we, wm = exclusive(warp_sum[d], d)  # warp 0: the warps before each
        entering = apply(carry_m[d][:, None], (we, wm))  # [tiles, warps, kind, word]
        sets.append(apply(entering[:, :, None], scans[d]).reshape(n_pad, 2, words))

    tr = np.flatnonzero(text_t >= 0)
    k, win = text_k[tr], text_w[tr]

    def longest(s):
        a = s[tr, k] & low(win, words)
        out = np.zeros(tr.shape[0], np.int64)
        for i in reversed(range(words)):
            h = high_bit(a[:, i])
            out = np.where((out == 0) & (h >= 0), 32 * i + h + 1, out)
        return out

    l_left, l_right = longest(sets[0]), longest(sets[1])
    best_len = np.maximum(l_left, l_right)
    row = np.where(best_len > 0, k * ml + best_len - 1, 0)
    ti, pos = tr // tile, tr % tile
    w0, bit = pos // lanes, pos % lanes
    full = 0xFFFFFFFF
    row_words = np.zeros((tiles, rows), np.int64)
    for w in range(warps):
        row_words |= (bits[:, w] != 0).astype(np.int64) << w
    here = bits[ti, w0, row]
    mask_words = row_words[ti, row]
    # the right sweep: the lowest pushing rank at or after r
    r_here = here & ((full << bit) & full)
    r_words = mask_words & ((full << (w0 + 1)) & full)
    r_w = low_bit(r_words)
    r_q = np.where(r_here > 0, ti * tile + w0 * lanes + low_bit(r_here),
                   np.where(r_words > 0, ti * tile + r_w * lanes
                            + low_bit(bits[ti, np.maximum(r_w, 0), row]),
                            np.where(carry_push[1][ti, row] >= 0,
                                     last - carry_push[1][ti, row], -1)))
    # the left sweep: the highest pushing rank at or before r
    l_here = here & ((2 << bit) - 1)
    l_words = mask_words & ((1 << w0) - 1)
    l_w = high_bit(l_words)
    l_q = np.where(l_here > 0, ti * tile + w0 * lanes + high_bit(l_here),
                   np.where(l_words > 0, ti * tile + l_w * lanes
                            + high_bit(bits[ti, np.maximum(l_w, 0), row]),
                            carry_push[0][ti, row]))
    q = np.where(l_right == best_len, r_q, l_q)
    ids = np.where((best_len > 0) & (q >= 0), who_id[np.clip(q, 0, last)], -1)
    best_id, out_len = np.empty(n_text, np.int64), np.empty(n_text, np.int64)
    best_id[text_t[tr]], out_len[text_t[tr]] = ids, best_len
    return best_id, out_len


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_model_equals_jax(name):
    """The kernels' decomposition (kernel_model) equals the JAX package on
    every case: the bitset step (kill, then push), the operator over
    lanes, warps and tiles, the push rows and carries, the cap-then-merge
    rule and the right sweep's reversed coordinates."""
    got_id, got_len = kernel_model(CASES[name])
    want_id, want_len = jax_match(name)
    np.testing.assert_array_equal(got_id, want_id)
    np.testing.assert_array_equal(got_len, want_len)


def random_runs(rng, n: int, words: int):
    """n random summaries: edges 0, kEdgeNone, past max_len and within it;
    sets of sparse random bits."""
    ml = 32 * words
    e = rng.choice(np.array([0, EDGE_NONE, ml + 1, ml + 40, *range(1, ml + 1)]), size=n)
    m = rng.integers(0, 1 << 32, size=(n, 2, words), dtype=np.uint64)
    m &= rng.integers(0, 1 << 32, size=(n, 2, words), dtype=np.uint64)
    return e.astype(np.int64), m.astype(np.uint32)


@pytest.mark.parametrize("words", [1, 2, 3])
def test_summary_operator_is_associative_with_identity(words):
    """(E, M_0, M_1) then (E', M_0', M_1') = (min(E, E'), (M & low(E')) |
    M'): associative, (kEdgeNone, 0, 0) its identity on both sides, and
    applying a combined run equals applying its two parts in turn."""
    rng = np.random.default_rng(100 + words)
    a, b, c = (random_runs(rng, 4000, words) for _ in range(3))
    for x, y in zip(combine(combine(a, b), c), combine(a, combine(b, c))):
        np.testing.assert_array_equal(x, y)
    ident = identity((4000,), words)
    for run in (combine(ident, a), combine(a, ident)):
        np.testing.assert_array_equal(run[0], a[0])
        np.testing.assert_array_equal(run[1], a[1])
    sets = random_runs(rng, 4000, words)[1]
    np.testing.assert_array_equal(apply(apply(sets, a), b), apply(sets, combine(a, b)))


def stack_walk(c: dict):
    """The match as the reference's get_closest walks it: each sweep visits
    the ranks in order with a stack of (length, rank) per kind, lengths
    rising to the top; an entering edge e pops every length above e, then
    the rank's push replaces its length's entry or is inserted in order;
    a text rank reads the longest entry under its window.  Then the right
    sweep wins ties."""
    rank, lcp, who_len, who_id, who_kind, window, wp = (c[k].astype(np.int64) for k in FIELDS)
    ml = c["max_len"]
    n_s, n_text = rank.shape[0], window.shape[0]
    text_of = np.full(n_s, -1)
    text_of[rank[:n_text]] = np.arange(n_text)
    found = np.zeros((2, n_text, 2), np.int64)
    for d, order in enumerate((range(n_s), range(n_s - 1, -1, -1))):
        stacks = ([], [])
        for r in order:
            e = (lcp[r - 1] if r > 0 else None) if d == 0 else (lcp[r] if r < n_s - 1 else None)
            for st in stacks:
                while e is not None and st and st[-1][0] > e:
                    st.pop()
            k, length = who_kind[r], who_len[r]
            if k in (0, 1) and 1 <= length <= ml:
                st = stacks[k]
                i = bisect.bisect_left([x[0] for x in st], length)
                st[i : i + (i < len(st) and st[i][0] == length)] = [(length, r)]
            t = text_of[r]
            if t >= 0:
                under = [x for x in stacks[int(wp[t])] if x[0] <= window[t]]
                found[d, t] = under[-1] if under else (0, -1)
    best_len = np.maximum(found[0, :, 0], found[1, :, 0])
    q = np.where(found[1, :, 0] == best_len, found[1, :, 1], found[0, :, 1])
    return np.where(best_len > 0, who_id[q], -1), best_len


@pytest.mark.parametrize("name", sorted(CASES))
def test_one_rank_tiles_model_equals_stack_walk(name):
    """kernel_model with one rank a tile (every step a carry between tiles)
    equals the sequential stack walk, which equals the JAX package."""
    got_id, got_len = kernel_model(CASES[name], tile=1)
    want_id, want_len = stack_walk(CASES[name])
    np.testing.assert_array_equal(got_len, want_len)
    np.testing.assert_array_equal(got_id, want_id)
    jax_id, jax_len = jax_match(name)
    np.testing.assert_array_equal(want_len, jax_len)
    np.testing.assert_array_equal(want_id, jax_id)


def case_tensors(name: str, device="cpu"):
    return [torch.from_numpy(CASES[name][k]).to(device) for k in FIELDS]


def test_cpu_call_builds_no_library(monkeypatch):
    """On CPU tensors the dispatcher runs the plain version: nothing is
    built or loaded, and no launch is counted."""
    from wordpiece_tpu_torch.ops import cuda_build

    def refuse(*args, **kwargs):
        raise AssertionError("a CPU call tried to build or load a CUDA library")

    monkeypatch.setattr(lcu, "build", refuse)
    monkeypatch.setattr(cuda_build, "build_library", refuse)
    before = lm.match_from_sa.launches
    lm.match_from_sa(*case_tensors("synthetic_n_s_5"), max_len=4)
    assert lm.match_from_sa.launches == before


def test_other_device_raises():
    with pytest.raises(ValueError, match="unsupported device meta"):
        lm.match_from_sa(*case_tensors("synthetic_n_s_5", "meta"), max_len=4)


@pytest.mark.parametrize("moved", range(1, len(FIELDS)))
def test_mixed_devices_raise(moved):
    """Every operand must lie on rank's device, on the CPU too."""
    args = case_tensors("synthetic_n_s_5")
    args[moved] = args[moved].to("meta")
    with pytest.raises(ValueError, match=f"rank on cpu, {FIELDS[moved]} on meta"):
        lm.match_from_sa(*args, max_len=4)


@pytest.mark.parametrize("max_len,n_text", [(0, 3), (lcu.MAX_LEN + 1, 3), (4, 6)])
def test_launch_refuses_what_the_kernels_do_not_take(monkeypatch, max_len, n_text):
    """The kernels' wrapper raises before any build on a max_len outside
    1..MAX_LEN and on n_text > n_s."""
    monkeypatch.setattr(lcu, "build", lambda **kw: pytest.fail("built"))
    args = case_tensors("synthetic_n_s_5")
    args[5] = torch.zeros(n_text, dtype=torch.int32)
    args[6] = torch.zeros(n_text, dtype=torch.bool)
    with pytest.raises(ValueError):
        lcu.launch(*args, max_len=max_len)


def test_kernel_limit_is_the_engines_routing_bound():
    """One length limit: the kernels' kMaxLen (read from their source), the
    wrapper's MAX_LEN and the engine's MAX_SLOT_LEN, past which the engine
    routes a vocabulary to the host."""
    with open(lcu.SOURCE) as f:
        k_max_len = int(re.search(r"constexpr int kMaxLen = (\d+);", f.read()).group(1))
    assert k_max_len == lcu.MAX_LEN == LinearEncoder.MAX_SLOT_LEN

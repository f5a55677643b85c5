"""The port's suffix-array sweeps (ops/linear_match.py: surviving_push,
_lastkill, match_from_sa) against the JAX package's, on the same
numpy-seeded suffix arrays and on bench/linear_cases.py's edge cases of
the CUDA kernels (csrc/linear_match.cu), where a numpy model of those
kernels is held to the JAX package too; and the dispatcher's refusals.
Integers: exact."""

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


def kernel_model(c: dict):
    """csrc/linear_match.cu in numpy, kernel by kernel, at its tile of
    linear_match_cuda.TILE ranks and its 32 lanes: the tiles kernel's
    aggregates (pushes; kills from the ranks whose edge is below every
    later edge of their warp, then a prefix max over edge values), the
    carry kernel's scan in 32 segments, and the walk's (direction, length)
    tasks with their skips, lane chunks, exclusive lane scan seeded with
    the carry, and the 64-bit (length, direction, slot) max per rank."""
    rank, lcp, who_len, who_id, who_kind, window, wp = (c[k].astype(np.int64) for k in FIELDS)
    ml = c["max_len"]
    n_s, n_text, last = rank.shape[0], window.shape[0], rank.shape[0] - 1
    tile = lcu.TILE
    chunk = tile // 32
    tiles = -(-n_s // tile)
    n_pad = tiles * tile
    r = np.arange(n_pad)
    edge = np.full((2, n_pad), 255)
    edge[0, 1:n_s] = np.clip(lcp[: n_s - 1], 0, 255)
    edge[1, : n_s - 1] = np.clip(lcp[: n_s - 1], 0, 255)
    ok = np.isin(who_kind, (0, 1)) & (who_len >= 1) & (who_len <= ml)
    plen, pkind = np.zeros(n_pad, np.int64), np.zeros(n_pad, np.int64)
    plen[:n_s], pkind[:n_s] = np.where(ok, who_len, 0), np.where(ok, who_kind, 0)
    text_at = np.full(n_pad, -1)
    text_at[rank[:n_text]] = np.arange(n_text)
    win = np.where(text_at >= 0, np.clip(window[text_at], 0, ml), 0)
    tkind = np.where(text_at >= 0, wp[text_at], 0)
    pos = np.stack([r, last - r])

    # Tiles kernel: [tile, direction, part, l - 1].
    agg = np.full((tiles, 2, 3, ml), -1)
    for d in range(2):
        e = edge[d].reshape(-1, 32)
        if d == 0:  # later ranks: higher lanes
            later = np.minimum.accumulate(e[:, ::-1], axis=1)[:, ::-1]
            later = np.concatenate([later[:, 1:], np.full((e.shape[0], 1), 256)], axis=1)
        else:  # later ranks: lower lanes
            later = np.minimum.accumulate(e, axis=1)
            later = np.concatenate([np.full((e.shape[0], 1), 256), later[:, :-1]], axis=1)
        posts = ((e < ml) & (e < later)).reshape(tiles, tile)
        p, ee = pos[d].reshape(tiles, tile), edge[d].reshape(tiles, tile)
        ln, kd = plen.reshape(tiles, tile), pkind.reshape(tiles, tile)
        kill_at = np.stack([np.where(posts & (ee == v), p, -1).max(axis=1) for v in range(ml)], 1)
        kill = np.maximum.accumulate(kill_at, axis=1)  # kill of length l: edges below l
        for l in range(1, ml + 1):
            agg[:, d, 0, l - 1] = np.where((ln == l) & (kd == 0), p, -1).max(axis=1)
            agg[:, d, 1, l - 1] = np.where((ln == l) & (kd == 1), p, -1).max(axis=1)
            agg[:, d, 2, l - 1] = kill[:, l - 1]

    # Carry kernel: tiles in each sweep's order, 32 segments.
    carry = np.empty_like(agg)
    seed = np.array([-1, -1, 0])[:, None]
    per = -(-tiles // 32)
    for d in range(2):
        order = np.arange(tiles) if d == 0 else np.arange(tiles)[::-1]
        run = np.broadcast_to(seed, (3, ml)).copy()
        for a in range(0, tiles, per):
            seg = order[a : a + per]
            for t in seg:
                carry[t, d] = run
                run = np.maximum(run, agg[t, d])

    # Walk kernel.
    best = np.zeros(n_pad, np.int64)
    for t in range(tiles):
        loc = slice(t * tile, (t + 1) * tile)
        maxwin = win[loc].max()
        pushed = set(plen[loc][plen[loc] > 0].tolist())
        for task in range(2 * ml):
            d, l = task & 1, (task >> 1) + 1
            if l > maxwin:
                continue
            c0, c1, ck = carry[t, d, :, l - 1]
            if l not in pushed and not (0 <= c0 and ck <= c0) and not (0 <= c1 and ck <= c1):
                continue
            order = np.arange(tile) if d == 0 else np.arange(tile)[::-1]  # the sweep's order
            at = t * tile + order
            p = pos[d, at].reshape(32, chunk)
            push0 = np.where((plen[at] == l) & (pkind[at] == 0), pos[d, at], -1).reshape(32, chunk)
            push1 = np.where((plen[at] == l) & (pkind[at] == 1), pos[d, at], -1).reshape(32, chunk)
            kills = np.where(edge[d, at] < l, p.ravel(), -1).reshape(32, chunk)
            running = []
            for vals, cv in ((push0, c0), (push1, c1), (kills, ck)):
                lanes = np.maximum.accumulate(vals.max(axis=1))
                start = np.maximum(cv, np.concatenate([[-1], lanes[:-1]]))
                running.append(np.maximum(start[:, None], np.maximum.accumulate(vals, axis=1)))
            q = np.where(tkind[at] == 1, running[1].ravel(), running[0].ravel())
            alive = (win[at] >= l) & (q >= 0) & (q >= running[2].ravel())
            key = (l << 33) | (d << 32) | np.maximum(q, 0)
            best[at] = np.maximum(best[at], np.where(alive, key, 0))

    key = best[rank[:n_text]]
    best_len = key >> 33
    q = key & 0xFFFFFFFF
    q_true = np.where((key >> 32) & 1, last - q, q)
    best_id = np.where(best_len > 0, who_id[np.clip(q_true, 0, last)], -1)
    return best_id, best_len


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_model_equals_jax(name):
    """The kernels' decomposition (kernel_model) equals the JAX package on
    every case: the cap-then-merge rule, the reversed coordinates of the
    right sweep, the carries across tiles and the skipped lengths."""
    got_id, got_len = kernel_model(CASES[name])
    want_id, want_len = jax_match(name)
    np.testing.assert_array_equal(got_id, want_id)
    np.testing.assert_array_equal(got_len, want_len)


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

"""The port's suffix-array sweeps (ops/linear_match.py: surviving_push,
_lastkill, match_from_sa) against the JAX package's, on the same
numpy-seeded suffix arrays.  Integers: exact."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wordpiece_tpu.ops import linear_match as jlm
from wordpiece_tpu_torch.ops import linear_match as lm
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

"""The port's prefix-doubling suffix array and clamped LCP (the linear
engine's fallback) against a brute-force reference and the JAX package's
suffix_array / lcp_clamped, on the same numpy-seeded inputs.  Integers:
exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wordpiece_tpu.ops.suffix_array import lcp_clamped as jax_lcp
from wordpiece_tpu.ops.suffix_array import suffix_array as jax_sa
from wordpiece_tpu_torch.ops.suffix_array import lcp_clamped, suffix_array

torch.set_num_threads(1)


def ref_suffix_array(s):
    return np.array(sorted(range(len(s)), key=lambda i: s[i:]), dtype=np.int32)


def ref_lcp(s, sa):
    out = np.zeros(len(s), dtype=np.int32)
    for r in range(len(s) - 1):
        a, b = s[sa[r] :], s[sa[r + 1] :]
        k = 0
        while k < len(a) and k < len(b) and a[k] == b[k]:
            k += 1
        out[r] = k
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n", [1, 2, 7, 50, 257])
def test_suffix_array_and_lcp(seed, n):
    rng = np.random.default_rng(seed)
    s = rng.integers(1, 5, size=n).astype(np.int32)
    sa, rank = suffix_array(torch.from_numpy(s))
    want_sa = ref_suffix_array(s.tolist())
    np.testing.assert_array_equal(sa.numpy(), want_sa)
    np.testing.assert_array_equal(rank.numpy()[want_sa], np.arange(n))
    jsa, jrank = jax_sa(jnp.asarray(s))
    np.testing.assert_array_equal(sa.numpy(), np.asarray(jsa))
    np.testing.assert_array_equal(rank.numpy(), np.asarray(jrank))
    clamp = 9
    lcp = lcp_clamped(torch.from_numpy(s), sa, clamp=clamp)
    np.testing.assert_array_equal(lcp.numpy(), np.minimum(ref_lcp(s.tolist(), want_sa), clamp))
    np.testing.assert_array_equal(lcp.numpy(), np.asarray(jax_lcp(jnp.asarray(s), jsa, clamp=clamp)))


def test_suffix_array_with_separators_and_distinct_pads():
    """The fallback's S: text, -1 separators, token symbols, then distinct
    pad values above every codepoint."""
    rng = np.random.default_rng(5)
    text = rng.integers(97, 100, size=40)
    toks = [rng.integers(97, 100, size=int(rng.integers(1, 5))) for _ in range(8)]
    parts = [text, [-1]]
    for t in toks:
        parts += [t, [-1]]
    core = np.concatenate(parts).astype(np.int32)
    s = np.concatenate([core, 0x110001 + np.arange(128 - core.shape[0])]).astype(np.int32)
    sa, rank = suffix_array(torch.from_numpy(s))
    np.testing.assert_array_equal(sa.numpy(), ref_suffix_array(s.tolist()))
    jsa, jrank = jax_sa(jnp.asarray(s))
    np.testing.assert_array_equal(rank.numpy(), np.asarray(jrank))
    lcp = lcp_clamped(torch.from_numpy(s), sa, clamp=4)
    np.testing.assert_array_equal(lcp.numpy(), np.asarray(jax_lcp(jnp.asarray(s), jsa, clamp=4)))

"""The port's per-position text features (ops/text_features.compute_features
and its reverse-cummin helper) against the JAX package's, on the same
numpy-seeded codepoints.  Every field is an integer or a flag: exact."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wordpiece_tpu.ops import text_features as jtf
from wordpiece_tpu_torch.core import unicode as uni
from wordpiece_tpu_torch.ops import text_features as tf

torch.set_num_threads(1)

FIELDS = ("space", "punct", "spacing", "wp", "window", "ss", "wnext")


def random_codepoints(rng, n: int) -> np.ndarray:
    """Letters, spaces (incl. tab and the SPACE_TOKEN), ASCII and Unicode
    punctuation, Cyrillic and CJK, in runs so that words form."""
    pools = [
        np.arange(97, 123),
        np.array([32, 9, 10, uni.SPACE_TOKEN]),
        np.array([33, 44, 45, 46, 63, 171, 187, 183, 8212]),
        np.arange(0x430, 0x450),
        np.arange(0x4E00, 0x4E40),
    ]
    weights = np.array([0.55, 0.2, 0.08, 0.1, 0.07])
    kinds = rng.choice(len(pools), size=n, p=weights)
    return np.array([rng.choice(pools[k]) for k in kinds], dtype=np.int32)


@pytest.mark.parametrize(
    "n,n_valid,max_len,seed",
    [(1, 1, 1, 0), (37, 30, 5, 1), (256, 256, 16, 2), (256, 200, 16, 3), (128, 0, 4, 4)],
)
def test_compute_features_equals_jax(n, n_valid, max_len, seed):
    cp = random_codepoints(np.random.default_rng(seed), n)
    got = tf.compute_features(torch.from_numpy(cp), n_valid, max_len)
    want = jax.jit(partial(jtf.compute_features, max_len=max_len))(
        jnp.asarray(cp), jnp.int32(n_valid)
    )
    for name in FIELDS:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("n", [1, 9, 130])
def test_next_at_or_after_equals_jax(n):
    flag = np.random.default_rng(n).random(n) < 0.2
    got = tf._next_at_or_after(torch.from_numpy(flag), n)
    want = jtf._next_at_or_after(jnp.asarray(flag), n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32 and got.shape == (n + 1,) and int(got[-1]) == n

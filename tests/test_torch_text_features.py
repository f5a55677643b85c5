"""The port's per-position text features (ops/text_features.compute_features
and its reverse-cummin helper) against the JAX package's, on the same
numpy-seeded codepoints, including the CUDA kernel's edge cases
(bench/stream_cases.py), which chip_smoke.py runs through the kernel on
the card.  Every field is an integer or a flag: exact."""

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wordpiece_tpu.ops import text_features as jtf
from wordpiece_tpu_torch.bench import stream_cases
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


# ---- the kernel's edge cases (bench/stream_cases.py), on the plain version ----------
CASES = stream_cases.feature_cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_compute_features_edge_cases_equal_jax(name):
    """Around the kernel's tile (n = 1, 128, 1,023, 1,025, 2,047, 2,049,
    4,097), n_valid < n, a spacing-free text over four tiles, an all-space
    text, the 2,000-codepoint space-free run, the 5,000-`q` run,
    punctuation-dense, CJK and astral-plane text: every field, whole,
    exactly."""
    cp, n_valid, max_len = CASES[name]
    got = tf.compute_features(torch.from_numpy(cp), n_valid, max_len)
    want = jax.jit(partial(jtf.compute_features, max_len=max_len))(
        jnp.asarray(cp), jnp.int32(n_valid)
    )
    for field in FIELDS:
        g, w = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    assert int(got.ss[-1]) == int(got.wnext[-1]) == cp.shape[0]


def test_compute_features_takes_any_integer_layout():
    """The wrapper reads its input as contiguous int32: an int16 or int64
    tensor, or a strided view, gives the features of its int32 copy."""
    cp = stream_cases.random_codepoints(np.random.default_rng(5), 600)
    want = tf.compute_features(torch.from_numpy(cp), 500, 8)
    wide = torch.from_numpy(np.repeat(cp, 2).astype(np.int64))[::2]
    assert not wide.is_contiguous()
    for src in (wide, torch.from_numpy(cp.astype(np.int16))):
        got = tf.compute_features(src, 500, 8)
        for field in FIELDS:
            assert torch.equal(getattr(got, field), getattr(want, field)), field
    bad_inputs = (torch.zeros(2, 3, dtype=torch.int32), torch.zeros(4),
                  torch.zeros(4, dtype=torch.bool))
    for bad in bad_inputs:
        with pytest.raises(ValueError):
            tf.compute_features(bad, 4, 2)


def test_cpu_call_builds_no_library(monkeypatch):
    """On CPU tensors the wrapper runs the plain version: nothing is built
    or loaded."""
    from wordpiece_tpu_torch.ops import cuda_build, text_features_cuda

    def refuse(*args, **kwargs):
        raise AssertionError("a CPU call tried to build or load a CUDA library")

    monkeypatch.setattr(text_features_cuda, "build", refuse)
    monkeypatch.setattr(cuda_build, "build_library", refuse)
    before = tf.compute_features.launches
    cp, n_valid, max_len = CASES["n_2049"]
    tf.compute_features(torch.from_numpy(cp), n_valid, max_len)
    assert tf.compute_features.launches == before


@pytest.mark.parametrize("ranges", ["port", "jax"])
def test_kernel_chinese_ranges_equal_unicode_tables(ranges):
    """csrc/classify.cuh's is_chinese compares against the ranges of
    core/unicode._CHINESE_RANGES, in order: the CPU's guard on the
    kernel's classifier, which only the card can run."""
    import re

    from wordpiece_tpu.core import unicode as juni

    header = os.path.join(os.path.dirname(tf.__file__), "..", "csrc", "classify.cuh")
    src = open(header, encoding="utf-8").read()
    body = src[src.index("bool is_chinese("):]
    body = body[: body.index("}")]
    pairs = re.findall(r"c >= (0x[0-9A-Fa-f]+)u && c <= (0x[0-9A-Fa-f]+)u", body)
    got = tuple((int(lo, 16), int(hi, 16)) for lo, hi in pairs)
    assert got == (uni._CHINESE_RANGES if ranges == "port" else juni._CHINESE_RANGES)
    assert "kSpaceToken = 9601u" in src and uni.SPACE_TOKEN == 9601

"""The port's greedy commit (ops/commit.py) against the JAX package's
commit_with_positions / commit, on the same numpy-seeded matches.  The
port runs a fixed number of pointer-doubling rounds where the JAX package
loops until nothing changes; both must give the same ids, positions and
count.  Integers: exact."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wordpiece_tpu.ops import commit as jcommit
from wordpiece_tpu.ops import text_features as jtf
from wordpiece_tpu_torch.bench import stream_cases
from wordpiece_tpu_torch.engine_linear import _longest_unit
from wordpiece_tpu_torch.ops import commit
from wordpiece_tpu_torch.ops import text_features as tf

torch.set_num_threads(1)

UNK = 7


def random_case(seed: int, n: int, n_valid: int, max_len: int):
    """Codepoints with words, punctuation and CJK, and random matches that
    respect the probe window (best_len in [0, window])."""
    rng = np.random.default_rng(seed)
    pool = np.array([97, 98, 99, 100, 32, 32, 44, 45, 0x4E00, 0x430], dtype=np.int32)
    cp = rng.choice(pool, size=n).astype(np.int32)
    feats = tf.compute_features(torch.from_numpy(cp), n_valid, max_len)
    window = feats.window.numpy()
    best_len = (rng.random(n) * (window + 1)).astype(np.int32)
    best_len[rng.random(n) < 0.15] = 0
    best_id = np.where(best_len > 0, rng.integers(0, 500, size=n), -1).astype(np.int32)
    return cp, feats, best_id, best_len


def jax_commit(cp, n_valid, max_len, best_id, best_len):
    @partial(jax.jit, static_argnames=("max_len",))
    def run(cp, n_valid, best_id, best_len, *, max_len):
        feats = jtf.compute_features(cp, n_valid, max_len)
        return jcommit.commit_with_positions(best_id, best_len, feats, n_valid, unk_id=UNK)

    out = run(jnp.asarray(cp), jnp.int32(n_valid), jnp.asarray(best_id),
              jnp.asarray(best_len), max_len=max_len)
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("bound", ["n", "longest_unit"])
@pytest.mark.parametrize("seed,n,n_valid,max_len", [(0, 256, 256, 6), (1, 256, 190, 3), (2, 37, 37, 16)])
def test_commit_with_positions_equals_jax(seed, n, n_valid, max_len, bound):
    cp, feats, best_id, best_len = random_case(seed, n, n_valid, max_len)
    max_chain = n if bound == "n" else _longest_unit(cp[:n_valid])
    ids, positions, count = commit.commit_with_positions(
        torch.from_numpy(best_id), torch.from_numpy(best_len), feats, n_valid,
        unk_id=UNK, max_chain=max_chain,
    )
    want_ids, want_pos, want_count = jax_commit(cp, n_valid, max_len, best_id, best_len)
    assert int(count) == int(want_count) > 0
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_array_equal(positions.numpy(), want_pos)
    c = int(count)
    assert (np.diff(positions.numpy()[:c]) > 0).all()
    short_ids, short_count = commit.commit(
        torch.from_numpy(best_id), torch.from_numpy(best_len), feats, n_valid,
        unk_id=UNK, max_chain=max_chain,
    )
    np.testing.assert_array_equal(short_ids.numpy(), want_ids)
    assert int(short_count) == c


def test_long_within_unit_chain():
    """One unit of 2,000 single-codepoint tokens: a chain of 2,000 steps,
    reached in doubling_rounds(2000) = 11 rounds with no host check; a
    bound below the chain leaves its tail unvisited."""
    n = 2048
    cp = np.full(n, 32, dtype=np.int32)
    cp[:2000] = 97
    feats = tf.compute_features(torch.from_numpy(cp), n, 1)
    best_len = np.where(cp == 97, 1, 0).astype(np.int32)
    best_id = np.where(best_len > 0, 3, -1).astype(np.int32)
    assert _longest_unit(cp) == 2000 and commit.doubling_rounds(2000) == 11
    want_ids, want_pos, want_count = jax_commit(cp, n, 1, best_id, best_len)
    assert int(want_count) == 2000
    for max_chain in (n, 2000):
        ids, positions, count = commit.commit_with_positions(
            torch.from_numpy(best_id), torch.from_numpy(best_len), feats, n,
            unk_id=UNK, max_chain=max_chain,
        )
        assert int(count) == 2000
        np.testing.assert_array_equal(ids.numpy(), want_ids)
        np.testing.assert_array_equal(positions.numpy(), want_pos)
    _, _, short = commit.commit_with_positions(
        torch.from_numpy(best_id), torch.from_numpy(best_len), feats, n,
        unk_id=UNK, max_chain=1000,
    )
    assert int(short) == 1024


@pytest.mark.parametrize(
    "max_chain,rounds", [(1, 0), (2, 1), (3, 2), (4, 2), (5, 3), (1024, 10), (1025, 11)]
)
def test_doubling_rounds(max_chain, rounds):
    assert commit.doubling_rounds(max_chain) == rounds
    # After k rounds the visited set holds F^j(seed) for every j < 2^k.
    assert 2**rounds >= max_chain and (rounds == 0 or 2 ** (rounds - 1) < max_chain)


# ---- the kernels' edge cases (bench/stream_cases.py), on the plain version ----------
CASES = stream_cases.feature_cases()


@pytest.mark.parametrize("bound", ["n", "longest_unit"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_commit_edge_cases_equal_jax(name, bound):
    """The features' edge cases with random matches inside the window
    (stream_cases.random_matches), max_chain n and the longest unit: ids,
    positions and count equal the JAX package's, whole with the padding."""
    cp, n_valid, max_len = CASES[name]
    feats = tf.compute_features(torch.from_numpy(cp), n_valid, max_len)
    rng = np.random.default_rng(len(name))
    best_id, best_len = stream_cases.random_matches(rng, feats.window.numpy())
    n = cp.shape[0]
    max_chain = n if bound == "n" else _longest_unit(cp[:n_valid])
    ids, positions, count = commit.commit_with_positions(
        torch.from_numpy(best_id), torch.from_numpy(best_len), feats, n_valid,
        unk_id=UNK, max_chain=max_chain,
    )
    want_ids, want_pos, want_count = jax_commit(cp, n_valid, max_len, best_id, best_len)
    assert int(count) == int(want_count)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_array_equal(positions.numpy(), want_pos)
    assert ids.dtype == positions.dtype == count.dtype == torch.int32 and count.dim() == 0


def test_q_run_drives_max_chain():
    """The dry run's 5,000-`q` unit with one-codepoint matches: a chain of
    5,000 steps, doubling_rounds(5000) = 13 rounds, equal to the JAX
    package's loop to the fixed point."""
    cp = stream_cases.q_run()
    n = cp.shape[0]
    feats = tf.compute_features(torch.from_numpy(cp), n, 1)
    best_id, best_len = stream_cases.single_matches(cp)
    assert _longest_unit(cp) == 5000 and commit.doubling_rounds(5000) == 13
    want_ids, want_pos, want_count = jax_commit(cp, n, 1, best_id, best_len)
    assert int(want_count) == 5004
    ids, positions, count = commit.commit_with_positions(
        torch.from_numpy(best_id), torch.from_numpy(best_len), feats, n,
        unk_id=UNK, max_chain=5000,
    )
    assert int(count) == 5004
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_array_equal(positions.numpy(), want_pos)


def test_cpu_call_builds_no_library(monkeypatch):
    """On CPU tensors the wrapper runs the plain version: nothing is built
    or loaded, and no launch is counted."""
    from wordpiece_tpu_torch.ops import commit_cuda, cuda_build

    def refuse(*args, **kwargs):
        raise AssertionError("a CPU call tried to build or load a CUDA library")

    monkeypatch.setattr(commit_cuda, "build", refuse)
    monkeypatch.setattr(cuda_build, "build_library", refuse)
    before = commit.commit_with_positions.launches
    cp, feats, best_id, best_len = random_case(3, 300, 300, 6)
    commit.commit(torch.from_numpy(best_id), torch.from_numpy(best_len), feats, 300,
                  unk_id=UNK, max_chain=300)
    assert commit.commit_with_positions.launches == before


def test_mixed_devices_raise():
    """The wrapper checks that every input lies on best_id's device, on
    the CPU too."""
    cp, feats, best_id, best_len = random_case(4, 64, 64, 6)
    feats.ss = feats.ss.to("meta")
    with pytest.raises(ValueError, match="ss on meta"):
        commit.commit_with_positions(torch.from_numpy(best_id), torch.from_numpy(best_len),
                                     feats, 64, unk_id=UNK, max_chain=64)

"""The port's greedy commit (ops/commit.py) against the JAX package's
commit_with_positions / commit, on the same numpy-seeded matches.  Both
loop their pointer-doubling rounds until a round marks nothing new; they
must give the same ids, positions and count, with an UNK id of 7 and with
-1, the id of a vocabulary without [UNK].  A numpy model of the CUDA
kernels' tile-local walk (csrc/commit.cu: doubling inside each tile, one
carry between tiles, the kill across tiles from one byte a tile) is held
to the JAX package too, at the kernels' tile and at a small one.
Integers: exact."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wordpiece_tpu.ops import commit as jcommit
from wordpiece_tpu.ops import text_features as jtf
from wordpiece_tpu_torch.bench import stream_cases
from wordpiece_tpu_torch.ops import commit
from wordpiece_tpu_torch.ops import text_features as tf

torch.set_num_threads(1)

UNK = 7
UNKS = [UNK, -1]  # -1: the random-split vocabularies' unk_id (no [UNK] line)


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


def jax_commit(cp, n_valid, max_len, best_id, best_len, unk=UNK):
    @partial(jax.jit, static_argnames=("max_len", "unk"))
    def run(cp, n_valid, best_id, best_len, *, max_len, unk):
        feats = jtf.compute_features(cp, n_valid, max_len)
        return jcommit.commit_with_positions(best_id, best_len, feats, n_valid, unk_id=unk)

    out = run(jnp.asarray(cp), jnp.int32(n_valid), jnp.asarray(best_id),
              jnp.asarray(best_len), max_len=max_len, unk=unk)
    return [np.asarray(o) for o in out]


def single_unit(chain: int, n: int):
    """One unit of `chain` codepoints at 0, spaces to n, a one-codepoint
    match at each: a walk of `chain` steps."""
    cp = np.full(n, 32, dtype=np.int32)
    cp[:chain] = 97
    best_len = np.where(cp == 97, 1, 0).astype(np.int32)
    best_id = np.where(best_len > 0, 3, -1).astype(np.int32)
    return cp, best_id, best_len


@pytest.mark.parametrize("unk", UNKS)
@pytest.mark.parametrize("seed,n,n_valid,max_len", [(0, 256, 256, 6), (1, 256, 190, 3), (2, 37, 37, 16)])
def test_commit_with_positions_equals_jax(seed, n, n_valid, max_len, unk):
    cp, feats, best_id, best_len = random_case(seed, n, n_valid, max_len)
    ids, positions, count = commit.commit_with_positions(
        torch.from_numpy(best_id), torch.from_numpy(best_len), feats, n_valid, unk_id=unk,
    )
    want_ids, want_pos, want_count = jax_commit(cp, n_valid, max_len, best_id, best_len, unk)
    assert int(count) == int(want_count) > 0
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_array_equal(positions.numpy(), want_pos)
    c = int(count)
    assert (np.diff(positions.numpy()[:c]) > 0).all()
    short_ids, short_count = commit.commit(
        torch.from_numpy(best_id), torch.from_numpy(best_len), feats, n_valid, unk_id=unk,
    )
    np.testing.assert_array_equal(short_ids.numpy(), want_ids)
    assert int(short_count) == c


def test_long_within_unit_chain():
    """One unit of 2,000 single-codepoint tokens: a chain of 2,000 steps,
    walked to the fixed point, equal to the JAX package."""
    n = 2048
    cp, best_id, best_len = single_unit(2000, n)
    feats = tf.compute_features(torch.from_numpy(cp), n, 1)
    want_ids, want_pos, want_count = jax_commit(cp, n, 1, best_id, best_len)
    assert int(want_count) == 2000
    ids, positions, count = commit.commit_with_positions(
        torch.from_numpy(best_id), torch.from_numpy(best_len), feats, n, unk_id=UNK,
    )
    assert int(count) == 2000
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_array_equal(positions.numpy(), want_pos)


@pytest.mark.parametrize("chain", [1, 2, 3, 4, 5, 1024, 1025])
def test_fixed_point_rounds(chain):
    """A unit of `chain` one-codepoint matches: ids and positions equal
    the JAX package's, and the plain walk stops one round after its last
    new mark.  After k rounds the visited set holds F^j(seed) for every
    j < 2^k, so the chain's last position is first marked in round
    (chain - 1).bit_length() (none for a chain of 1, which its seed
    covers), and the round after it marks nothing."""
    n = max(128, 2 * chain)
    cp, best_id, best_len = single_unit(chain, n)
    feats = tf.compute_features(torch.from_numpy(cp), n, 1)
    want_ids, want_pos, want_count = jax_commit(cp, n, 1, best_id, best_len)
    ids, positions, count = commit.commit_with_positions(
        torch.from_numpy(best_id), torch.from_numpy(best_len), feats, n, unk_id=UNK,
    )
    assert int(count) == int(want_count) == chain
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_array_equal(positions.numpy(), want_pos)
    assert commit.commit_with_positions_plain.rounds == (chain - 1).bit_length() + 1


# ---- the kernels' edge cases (bench/stream_cases.py), on the plain version ----------
CASES = stream_cases.feature_cases()


@pytest.mark.parametrize("unk", UNKS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_commit_edge_cases_equal_jax(name, unk):
    """The features' edge cases with random matches inside the window
    (stream_cases.random_matches), at each UNK id: ids, positions and
    count equal the JAX package's, whole with the padding."""
    cp, n_valid, max_len = CASES[name]
    feats = tf.compute_features(torch.from_numpy(cp), n_valid, max_len)
    rng = np.random.default_rng(len(name))
    best_id, best_len = stream_cases.random_matches(rng, feats.window.numpy())
    ids, positions, count = commit.commit_with_positions(
        torch.from_numpy(best_id), torch.from_numpy(best_len), feats, n_valid, unk_id=unk,
    )
    want_ids, want_pos, want_count = jax_commit(cp, n_valid, max_len, best_id, best_len, unk)
    assert int(count) == int(want_count)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_array_equal(positions.numpy(), want_pos)
    assert ids.dtype == positions.dtype == count.dtype == torch.int32 and count.dim() == 0


def test_q_run_walks_to_fixed_point():
    """The dry run's 5,000-`q` unit with one-codepoint matches: a chain of
    5,000 steps, walked in 14 rounds (the last marks nothing), equal to
    the JAX package's loop to the fixed point."""
    cp = stream_cases.q_run()
    n = cp.shape[0]
    feats = tf.compute_features(torch.from_numpy(cp), n, 1)
    best_id, best_len = stream_cases.single_matches(cp)
    want_ids, want_pos, want_count = jax_commit(cp, n, 1, best_id, best_len)
    assert int(want_count) == 5004
    ids, positions, count = commit.commit_with_positions(
        torch.from_numpy(best_id), torch.from_numpy(best_len), feats, n, unk_id=UNK,
    )
    assert commit.commit_with_positions_plain.rounds == 14
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
                  unk_id=UNK)
    assert commit.commit_with_positions.launches == before


def test_mixed_devices_raise():
    """The wrapper checks that every input lies on best_id's device, on
    the CPU too."""
    cp, feats, best_id, best_len = random_case(4, 64, 64, 6)
    feats.ss = feats.ss.to("meta")
    with pytest.raises(ValueError, match="ss on meta"):
        commit.commit_with_positions(torch.from_numpy(best_id), torch.from_numpy(best_len),
                                     feats, 64, unk_id=UNK)


# ---- the commit kernels' tile crossings (bench/stream_cases.commit_cases) ----------
COMMIT_CASES = stream_cases.commit_cases()


@pytest.mark.parametrize("unk", UNKS)
@pytest.mark.parametrize("name", sorted(COMMIT_CASES))
def test_commit_tile_crossings_equal_jax(name, unk):
    """Units at tile edges, words over 2 and 3 tiles with their only
    failure in the last, a failure in a tile with no unit start, all-space
    tiles between units, n_valid after a straddling unit: the plain
    version equals the JAX package, with exactly one UNK, at each UNK
    id."""
    cp, n_valid, max_len, best_id, best_len = COMMIT_CASES[name]
    feats = tf.compute_features(torch.from_numpy(cp), n_valid, max_len)
    ids, positions, count = commit.commit_with_positions(
        torch.from_numpy(best_id), torch.from_numpy(best_len), feats, n_valid, unk_id=unk,
    )
    want_ids, want_pos, want_count = jax_commit(cp, n_valid, max_len, best_id, best_len, unk)
    assert int(count) == int(want_count) > 0
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_array_equal(positions.numpy(), want_pos)
    assert int((want_ids == unk).sum()) == 1


HAS_START, FAIL_HEAD, FAIL_TAIL = 1, 2, 4  # csrc/commit.cu's byte a tile


def _double(jump, mark, until_jumps: bool):
    """commit.cu's double_rounds: a marked position marks its jump's
    target, every jump is squared, until a round marks nothing new (or,
    with until_jumps, moves no jump)."""
    while True:
        nxt = jump[jump]
        new = mark.copy()
        new[jump[mark]] = True
        changed = (nxt != jump).any() if until_jumps else (new != mark).any()
        jump, mark = nxt, new
        if not changed:
            return jump, mark


def tile_walk_model(best_id, best_len, feats, n_valid: int, unk_id: int, tile: int):
    """numpy model of the CUDA commit (csrc/commit.cu) with `tile`
    positions a tile: the walk kernel's marks and carry, then the emit
    kernel's kill across tiles and compacted writes.  Returns (ids,
    positions, count) as the kernels write them."""
    space, wp = feats.space.numpy(), feats.wp.numpy()
    ss, wnext, window = feats.ss.numpy(), feats.wnext.numpy(), feats.window.numpy()
    n = best_id.shape[0]
    tiles = max(1, -(-n // tile))
    pos = np.arange(n)
    step = np.where(best_len > 0, ss[np.minimum(pos + best_len, n)],
                    ss[wnext[np.minimum(pos + window, n)]])
    f_all = np.where(space, n, step)
    seed_all = ~space & np.concatenate([[True], space[:-1]]) & (pos < min(n_valid, n))
    visited = np.zeros(tiles * tile, bool)
    record = np.zeros(tiles, np.uint8)
    carry_out = []
    l = np.arange(tile)
    for q in range(tiles):
        t0 = q * tile
        live = min(tile, n - t0)
        f = np.full(tile, n)
        f[:live] = f_all[t0:t0 + live]
        mark = np.zeros(tile, bool)
        mark[:live] = seed_all[t0:t0 + live]
        nonspace = np.zeros(tile, bool)
        nonspace[:live] = ~space[t0:t0 + live]
        u0 = int(np.argmax(mark)) if mark.any() else tile
        u_live = int(np.argmax(nonspace)) if nonspace.any() else tile
        jump = np.where((l < live) & (f - t0 < live), f - t0, l)
        jump = np.where((l < u0) & (jump >= u0), l, jump)
        if u_live < tile:
            jump, mark = _double(jump, mark, u0 == tile)
        carry_in = n if q == 0 else carry_out[q - 1]
        if u0 < tile:
            carry_out.append(int(f[np.nonzero(mark)[0].max()]))
        elif u_live == tile:
            carry_out.append(carry_in)  # passed on
        else:
            lc = carry_in - t0
            carry_out.append(int(f[jump[lc]]) if carry_in < n and lc < tile else carry_in)
        lc = carry_in - t0
        if u_live < u0 and carry_in < n and 0 <= lc < u0:
            hi = min(u0, live)
            jump = np.where((l < hi) & (f - t0 < hi), f - t0, l)
            start = np.zeros(tile, bool)
            start[lc] = True
            _, extra = _double(jump, start, False)
            mark |= extra
        visited[t0:t0 + tile] = mark
        failed = np.zeros(tile, bool)
        failed[:live] = mark[:live] & (best_len[t0:t0 + live] <= 0)
        prefix = np.zeros(tile, bool)
        prefix[:live] = wp[t0:t0 + live]
        starts = np.nonzero(mark & prefix)[0]
        fs, ls = (starts[0], starts[-1]) if len(starts) else (tile, -1)
        record[q] = ((HAS_START if len(starts) else 0) | (FAIL_HEAD * failed[l < fs].any())
                     | (FAIL_TAIL * failed[l >= ls].any()))

    def across(q, step):
        j = q + step
        while 0 <= j < tiles:
            if record[j] & HAS_START:
                return bool(record[j] & (FAIL_TAIL if step < 0 else FAIL_HEAD))
            if record[j] & FAIL_HEAD:
                return True
            j += step
        return False

    ids = np.full(n, -2, np.int32)
    positions = np.full(n, -1, np.int32)
    slot = 0
    for q in range(tiles):
        t0 = q * tile
        live = min(tile, n - t0)
        v = visited[t0:t0 + live]
        fl = v & (best_len[t0:t0 + live] <= 0)
        starts = v & wp[t0:t0 + live]
        seg = np.cumsum(starts)
        killed = np.zeros(tile + 1, bool)
        killed[seg[fl]] = True
        kill = (killed[seg] | ((seg == 0) & across(q, -1))
                | ((seg == int(starts.sum())) & across(q, 1)))
        emit = v & ((~fl & ~kill) | (starts & kill))
        at = np.nonzero(emit)[0]
        ids[slot:slot + len(at)] = np.where(kill[at], unk_id, best_id[t0 + at])
        positions[slot:slot + len(at)] = t0 + at
        slot += len(at)
    return ids, positions, slot


MODEL_CASES = ["n_1", "n_2049", "n_valid_below_n", "spacing_free_4_tiles", "all_space",
               "q_5000", "punct_dense"]


@pytest.mark.parametrize("tile", [64, stream_cases.TILE])
@pytest.mark.parametrize("name", MODEL_CASES + sorted(COMMIT_CASES))
def test_tile_walk_model_equals_jax(name, tile):
    """The kernels' algorithm, modelled in numpy at the kernels' tile and
    at a 64-position tile (every unit crosses tiles), equals the JAX
    package's loop to the fixed point: ids, positions and count."""
    if name in COMMIT_CASES:
        cp, n_valid, max_len, best_id, best_len = COMMIT_CASES[name]
        feats = tf.compute_features(torch.from_numpy(cp), n_valid, max_len)
    else:
        cp, n_valid, max_len = CASES[name]
        feats = tf.compute_features(torch.from_numpy(cp), n_valid, max_len)
        best_id, best_len = stream_cases.random_matches(np.random.default_rng(len(name)),
                                                        feats.window.numpy())
    ids, positions, count = tile_walk_model(best_id, best_len, feats, n_valid, UNK, tile)
    want_ids, want_pos, want_count = jax_commit(cp, n_valid, max_len, best_id, best_len)
    assert count == int(want_count)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(positions, want_pos)

"""Edge-case inputs of the text features and the greedy commit, from a seed.

The CPU tests (tests/test_torch_text_features.py, tests/test_torch_commit.py)
hold the plain versions (ops/text_features.compute_features_plain,
ops/commit.commit_with_positions_plain) to the JAX package on these cases,
and chip_smoke.py holds the CUDA kernels (csrc/text_features.cu,
csrc/commit.cu) to the plain versions on the same cases.  The commit's
walk takes TILE positions a block (its emit two tiles), and the features
kernel TILE below FEATURES_SMALL_N positions and FEATURES_TILE from there
(large_cases), so the lengths sit around their multiples, the carries of
both cross many tiles in the space-free and all-space texts, and
commit_cases puts units, failures and n_valid at the commit's tile
edges."""

from __future__ import annotations

import numpy as np

from ..core import unicode as uni

TILE = 2048  # kTile of csrc/commit.cu (the walk's tile)
# csrc/text_features.cu: 4,096-position tiles from FEATURES_SMALL_N
# positions on, TILE below.
FEATURES_TILE = 4096
FEATURES_SMALL_N = 1 << 19

SPACES = np.array([32, 9, 10, uni.SPACE_TOKEN], dtype=np.int32)
PUNCT = np.array([33, 44, 45, 46, 63, 171, 187, 183, 8212, 8249], dtype=np.int32)
LETTERS = np.arange(97, 123, dtype=np.int32)
CYRILLIC = np.arange(0x430, 0x450, dtype=np.int32)
CJK = np.arange(0x4E00, 0x4E40, dtype=np.int32)
ASTRAL = np.concatenate([np.arange(0x20000, 0x20010), np.arange(0x1F600, 0x1F610)]).astype(
    np.int32)


def random_codepoints(rng, n: int, weights=(0.55, 0.2, 0.08, 0.1, 0.07)) -> np.ndarray:
    """Letters, spaces (tab, newline and the SPACE_TOKEN too), ASCII and
    Unicode punctuation, Cyrillic and CJK, in the given proportions, so
    that words form."""
    pools = [LETTERS, SPACES, PUNCT, CYRILLIC, CJK]
    kinds = rng.choice(len(pools), size=n, p=np.asarray(weights) / np.sum(weights))
    out = np.empty(n, dtype=np.int32)
    for k, pool in enumerate(pools):
        at = kinds == k
        out[at] = rng.choice(pool, size=int(at.sum()))
    return out


def words_text(rng, n: int, pool: np.ndarray, word_len=(1, 9)) -> np.ndarray:
    """n codepoints: words of `pool` codepoints separated by single spaces."""
    out = np.full(n, 32, dtype=np.int32)
    i = 0
    while i < n:
        k = int(rng.integers(*word_len))
        out[i : i + k] = rng.choice(pool, size=min(k, n - i))
        i += k + 1
    return out


def q_run(n_q: int = 5000) -> np.ndarray:
    """The dry run's space-free run: a word, a space, n_q `q`, a space, a
    word (dryrun.py's at-scale text)."""
    return np.array([ord(c) for c in "ab " + "q" * n_q + " cd"], dtype=np.int32)


def feature_cases(seed: int = 0) -> dict:
    """name -> (cp int32[n], n_valid, max_len), small enough for the CPU
    tests: lengths 1, 128, around one and two tiles of either kernel,
    n_valid < n, a spacing-free text over four tiles, an all-space text, a
    2,000-codepoint space-free run, the 5,000-`q` run, and
    punctuation-dense, CJK and astral-plane text."""
    rng = np.random.default_rng(seed)
    cases = {
        "n_1": (np.array([97], dtype=np.int32), 1, 1),
        "n_128": (random_codepoints(rng, 128), 128, 16),
    }
    for n in (1023, 1025, TILE - 1, TILE + 1, 2 * TILE + 1):
        cases[f"n_{n}"] = (random_codepoints(rng, n), n, 16)
    cp = random_codepoints(rng, 2 * TILE + 100)
    cases["n_valid_below_n"] = (cp, 3000, 16)
    cases["spacing_free_4_tiles"] = (rng.choice(LETTERS, size=4 * TILE + 77).astype(np.int32),
                                     4 * TILE + 77, 16)
    cases["all_space"] = (rng.choice(SPACES, size=3 * TILE + 5).astype(np.int32), 3 * TILE + 5, 16)
    run = np.full(TILE, 32, dtype=np.int32)
    run[:2000] = rng.choice(LETTERS, size=2000)
    cases["space_free_2000"] = (run, TILE, 16)
    q = q_run()
    cases["q_5000"] = (q, int(q.shape[0]), 16)
    cases["punct_dense"] = (random_codepoints(rng, 3000, (0.4, 0.2, 0.4, 0.0, 0.0)), 3000, 16)
    cases["cjk"] = (random_codepoints(rng, 3000, (0.2, 0.2, 0.1, 0.0, 0.5)), 3000, 16)
    astral = words_text(rng, 3000, np.concatenate([LETTERS, ASTRAL, CJK]))
    cases["astral"] = (astral, 3000, 16)
    for n in (FEATURES_TILE - 1, 2 * FEATURES_TILE + 1):
        cases[f"n_{n}"] = (random_codepoints(rng, n), n, 16)
    return cases


def large_cases(seed: int = 0) -> dict:
    """Cases for the card only: a spacing-free text and an all-space text
    of 150 tiles each (the scans' look-back passes 32 tiles a step), and
    n_valid far below n; then the features kernel's 4,096-position tiles
    (from FEATURES_SMALL_N on): lengths on either side of that switch and
    around a tile, and a spacing-free text over 150 of them."""
    rng = np.random.default_rng(seed)
    n = 150 * TILE + 3
    cases = {
        "spacing_free_150_tiles": (rng.choice(LETTERS, size=n).astype(np.int32), n, 16),
        "all_space_150_tiles": (rng.choice(SPACES, size=n).astype(np.int32), n, 16),
        "n_valid_tenth_of_n": (random_codepoints(rng, n), n // 10, 16),
    }
    for n in (FEATURES_SMALL_N - 1, FEATURES_SMALL_N, FEATURES_SMALL_N + FEATURES_TILE + 1):
        cases[f"n_{n}"] = (random_codepoints(rng, n), n - 5, 16)
    n = 150 * FEATURES_TILE + 3
    cases["spacing_free_150_features_tiles"] = (rng.choice(LETTERS, size=n).astype(np.int32),
                                                n, 16)
    return cases


def commit_cases(seed: int = 0) -> dict:
    """name -> (cp int32[n], n_valid, max_len, best_id, best_len): the
    commit's tile crossings, with one-codepoint matches (every non-space
    position matches, id 3) and a failure placed by hand (best_len 0,
    best_id -1), so that a kill has to travel:
     - a unit that starts exactly at a tile start, and one that ends
       exactly at a tile end;
     - a word over 2 tiles and one over 3, each with its only failure in
       its last tile;
     - a failure in a tile that holds no unit start;
     - all-space tiles between two units;
     - n_valid inside a tile, after a unit that straddles into it."""
    rng = np.random.default_rng(seed)

    def letters(k):
        return rng.choice(LETTERS, size=k).astype(np.int32)

    def case(cp, n_valid, fails):
        best_id, best_len = single_matches(cp)
        for f in fails:
            best_id[f], best_len[f] = -1, 0
        return cp, n_valid, 16, best_id, best_len

    cases = {}
    cp = words_text(rng, 3 * TILE, LETTERS)
    cp[TILE - 1], cp[TILE : TILE + 5] = 32, letters(5)
    cp[2 * TILE - 6 : 2 * TILE], cp[2 * TILE] = letters(6), 32
    cases["unit_at_tile_start_and_end"] = case(cp, cp.shape[0], (TILE + 2,))
    for k in (2, 3):
        cp = words_text(rng, (k + 1) * TILE, LETTERS)
        lo, hi = TILE - 150, (k - 1) * TILE + 200
        cp[lo - 1], cp[lo:hi], cp[hi] = 32, letters(hi - lo), 32
        cases[f"word_over_{k}_tiles_fail_in_last"] = case(cp, cp.shape[0], (hi - 20,))
    cp = words_text(rng, 4 * TILE, LETTERS)
    lo, hi = TILE // 2, 3 * TILE + 10
    cp[lo - 1], cp[lo:hi], cp[hi] = 32, letters(hi - lo), 32
    cases["fail_in_tile_without_unit_start"] = case(cp, cp.shape[0], (TILE + TILE // 2,))
    cp = np.full(5 * TILE, 32, dtype=np.int32)
    cp[TILE - 40 : TILE - 3] = letters(37)
    cp[4 * TILE + 7 : 4 * TILE + 30] = letters(23)
    cases["all_space_tiles_between_units"] = case(cp, cp.shape[0], (4 * TILE + 9,))
    cp = words_text(rng, 3 * TILE, LETTERS)
    cp[TILE - 61], cp[TILE - 60 : TILE + 90], cp[TILE + 90] = 32, letters(150), 32
    cases["n_valid_in_tile_after_straddling_unit"] = case(cp, TILE + 300, (TILE + 40,))
    return cases


def random_matches(rng, window: np.ndarray, *, miss: float = 0.15, ids: int = 500):
    """(best_id, best_len) int32[n]: random matches that respect the probe
    window (best_len in [0, window]), a share `miss` of them none."""
    n = window.shape[0]
    best_len = (rng.random(n) * (window + 1)).astype(np.int32)
    best_len[rng.random(n) < miss] = 0
    best_id = np.where(best_len > 0, rng.integers(0, ids, size=n), -1).astype(np.int32)
    return best_id, best_len


def single_matches(cp: np.ndarray):
    """(best_id, best_len): every non-space position matches one
    codepoint (id 3), so a unit of k codepoints is a chain of k steps."""
    best_len = (~np.isin(cp, SPACES)).astype(np.int32)
    best_id = np.where(best_len > 0, 3, -1).astype(np.int32)
    return best_id, best_len

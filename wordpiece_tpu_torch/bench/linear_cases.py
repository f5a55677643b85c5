"""Inputs of the linear engine's match over the suffix array, from a seed.

The CPU tests (tests/test_torch_linear_match.py) hold the plain version
(ops/linear_match.match_from_sa_plain) and a numpy model of the CUDA
kernels to the JAX package's match_from_sa on these cases, and
chip_smoke.py holds the kernels (csrc/linear_match.cu) to the plain
version on the same cases.  Each case is a dict of numpy arrays, the
arguments of match_from_sa (rank, lcp, who_len, who_id, who_kind, window,
wp), and its max_len.

Two kinds of case:
 - synthetic: rank a random permutation, edges mostly near max_len (long
   survivals) with some low ones, a few 1<<30 edges, pushes of random
   kind and length with distinct ids (so the left and right slots of one
   length name different tokens), tokens at rank 0 and at the last rank,
   a few pushes the sweeps must ignore (length above max_len, kind -1),
   windows from 0 to past max_len, n_text < n_s; sizes that are not
   multiples of the kernels' TILE ranks, and one with a run of edges at
   max_len over three tiles with pushes at both ends;
 - built by the engine itself (engine_linear, on the CPU) from a
   vocabulary and a text: the main path's layout (text suffixes, then one
   element a token, sorted by packed keys; pad positions past the text)
   and the prefix-doubling fallback's (the suffix array of text, -1, the
   vocab tail and pad symbols), with tokens of both kinds at one string,
   a 1,500-codepoint run of one letter (equal keys over three tiles) and
   tokens of up to 96 codepoints.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.vocab import parse_vocab
from ..engine_linear import LinearEncoder, batch_match_inputs
from ..ops.linear_match_cuda import TILE
FIELDS = ("rank", "lcp", "who_len", "who_id", "who_kind", "window", "wp")


def synthetic(seed: int, n_s: int, n_text: int, max_len: int, run: tuple | None = None) -> dict:
    """A case with no string behind it (see the module docstring); `run`
    = (first, last) ranks whose edges are max_len, with a push of every
    length at the first and at the last."""
    rng = np.random.default_rng(seed)
    lcp = np.maximum(0, max_len + 1 - rng.geometric(0.3, size=n_s))
    low = rng.random(n_s) < 0.1
    lcp[low] = rng.integers(0, max_len + 1, size=int(low.sum()))
    lcp[rng.random(n_s) < 0.01] = 1 << 30
    who_len = np.where(rng.random(n_s) < 0.3, rng.integers(1, max_len + 1, size=n_s), 0)
    who_len[0], who_len[-1] = rng.integers(1, max_len + 1, size=2)
    who_kind = np.where(who_len > 0, rng.integers(0, 2, size=n_s), -1)
    ignored = rng.random(n_s) < 0.01
    who_len[ignored] = max_len + 1
    who_kind[rng.random(n_s) < 0.01] = -1
    if run is not None:
        first, last = run
        lcp[first:last] = max_len
        for q in (first, last):
            who_len[q : q + max_len] = np.arange(1, max_len + 1)[: n_s - q]
            who_kind[q : q + max_len] = rng.integers(0, 2, size=max_len)[: n_s - q]
    lcp[-1] = 0
    arrays = (rng.permutation(n_s), lcp, who_len, np.where(who_len > 0, rng.permutation(n_s), -1),
              who_kind, rng.integers(0, max_len + 4, size=n_text))
    return {**{k: np.asarray(a, np.int32) for k, a in zip(FIELDS, arrays)},
            "wp": rng.random(n_text) < 0.5, "max_len": max_len}


def _numpy_case(sa_tables, feats, max_len: int) -> dict:
    arrays = [*sa_tables, feats.window, feats.wp]
    return {**{k: a.cpu().numpy() for k, a in zip(FIELDS, arrays)}, "max_len": max_len}


def engine_case(lines: list[str], text: str, *, doubling: bool) -> dict:
    """The match's inputs of one batch of `text` as the linear engine
    builds them on the CPU: the main path's layout, or (`doubling`) the
    prefix-doubling fallback's."""
    enc = LinearEncoder(parse_vocab(lines), device="cpu")
    cps = np.array([ord(c) for c in text], dtype=np.int32)
    if doubling:
        return _numpy_case(*enc.doubling_inputs(cps), enc.max_len)
    m = enc._merge
    x_dense, cps_pad, _ = enc.batch_inputs(cps)

    def tensor(a):
        return torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16 else a)

    sa_tables, feats = batch_match_inputs(
        tensor(x_dense), tensor(cps_pad), int(cps.shape[0]), m.tok_keys, m.tok_len, m.tok_id,
        m.tok_kind, bits=m.bits, per=m.per, nk=m.nk, max_len=enc.max_len,
    )
    return _numpy_case(sa_tables, feats, enc.max_len)


def _words(rng, alphabet: str, n: int, longest: int) -> list[str]:
    letters = list(alphabet)
    return ["".join(rng.choice(letters, size=int(rng.integers(1, longest + 1))))
            for _ in range(n)]


def word_vocab(rng, longest: int) -> tuple[list[str], str]:
    """Every string over "abc" of up to 3 letters as a prefix and as a
    suffix token (both kinds at one string), random words over "abcd" of
    up to `longest` letters as tokens, and a text of those words and
    others."""
    short = [a + b + c for a in "abc" for b in ["", *"abc"] for c in ["", *"abc"] if b or not c]
    longs = sorted(set(_words(rng, "abcd", 60, longest)) - set(short))
    lines = ["[UNK]", *short, *("##" + s for s in short), *longs]
    text = " ".join(rng.choice(longs + _words(rng, "abcd", 200, 8), size=320))
    return lines, text


def cases(seed: int = 0) -> dict:
    """name -> case (module docstring), small enough for the CPU tests."""
    rng = np.random.default_rng(seed)
    out = {
        "synthetic_ml1": synthetic(seed + 1, 2 * TILE + 77, 2 * TILE - 30, 1),
        "synthetic_ml16": synthetic(seed + 2, 5 * TILE + 3, 4 * TILE, 16),
        "synthetic_ml33_n_text_n_s": synthetic(seed + 3, 3 * TILE + 100, 3 * TILE + 100, 33),
        "synthetic_ml96": synthetic(seed + 4, 4 * TILE - 1, 3 * TILE, 96),
        "synthetic_run_over_3_tiles": synthetic(seed + 5, 6 * TILE + 11, 5 * TILE, 16,
                                                run=(300, 300 + 3 * TILE + 40)),
        "synthetic_n_s_5": synthetic(seed + 6, 5, 3, 4),
    }
    lines, text = word_vocab(rng, 16)
    out["main_words"] = engine_case(lines, text, doubling=False)
    out["fallback_words"] = engine_case(lines, text, doubling=True)
    a_lines = ["[UNK]", *("a" * k for k in range(1, 34)), "##a", "##aa", "b", "##b"]
    a_text = "a" * 1500 + " b " + " ".join("a" * k for k in range(1, 40)) + " ab ba"
    out["main_a_run"] = engine_case(a_lines, a_text, doubling=False)
    longs = sorted(set(_words(rng, "abcd", 12, 96)) | {"abcd" * 24})
    l_text = " ".join(rng.choice(longs + [w[:50] for w in longs] + ["ab", "c"], size=40))
    out["fallback_ml96"] = engine_case(["[UNK]", *longs, "a", "b", "##c"], l_text, doubling=True)
    return out


def max_s_case(seed: int = 0, n_s: int = 1 << 20, max_len: int = 96) -> dict:
    """The card's case at MAX_S-scale nm: a synthetic case of n_s ranks,
    the text a sort's MAX_S batch less about 30,000 token elements."""
    return synthetic(seed, n_s, n_s - 30_000, max_len, run=(n_s // 3, n_s // 3 + 40 * TILE))

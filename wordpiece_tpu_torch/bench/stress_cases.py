"""The reference's differential stress inputs, from a seed.

The C++ reference's big stress (tests/tests.cpp:256-272) cuts a random
a-z string at random borders into a vocabulary that covers it (each piece
bare at offset 0 and ##-prefixed), positive (the whole split) and
negative (one entry erased).  These are the port's own copies of the
generators of the JAX package's reference-scale stress test
(tests/test_stress_reference_scale.py:37-146), with its seed: the same
seed gives the same text and vocabulary, character for character.  Two
regimes:

 1. one giant space-free unit (random_string) with a random_split
    vocabulary of multi-hundred-codepoint tokens;
 2. spaced Zipf-sampled words (spaced_corpus_and_vocab) with a vocabulary
    of random-split pieces of every distinct word, max_len <= 16.

Neither vocabulary has an [UNK] line, so its unk_id is -1.
tests/test_torch_stress_reference_scale.py runs the port's engines on
these on the CPU, and chip_smoke.py's stress phase on the card, each
against the native oracle.
"""

from __future__ import annotations

import numpy as np

SEED = 17  # the JAX test's (the reference's mt19937(17))


def random_string(rng: np.random.Generator, n: int) -> str:
    return "".join(np.array(list("abcdefghijklmnopqrstuvwxyz"))[rng.integers(0, 26, size=n)])


def random_split(s: str, rng: np.random.Generator, parts: int) -> list[str]:
    """The reference's randomSplit (tests/tests.cpp:111-135): cut at
    `parts` random borders; first piece also bare, every piece ##-form."""
    borders = {len(s)}
    while len(borders) < parts:
        borders.add(int(rng.integers(1, len(s))))
    vocab: set[str] = set()
    start = 0
    for b in sorted(borders):
        if start == 0:
            vocab.add(s[start:b])
        vocab.add("##" + s[start:b])
        start = b
    return sorted(vocab)


def spaced_corpus_and_vocab(rng: np.random.Generator, size_chars: int):
    """Zipf-sampled words of random a-z text; vocab = random split pieces
    of every distinct word (full coverage -> positive).  Returns (text,
    sorted vocab lines)."""
    n_words = 24_000
    lens = np.clip(rng.poisson(6.0, size=n_words) + 1, 1, 16)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    picks = rng.integers(0, 26, size=int(lens.sum()))
    joined = "".join(letters[picks])
    offs = np.concatenate([[0], np.cumsum(lens)])
    words = [joined[offs[i]: offs[i + 1]] for i in range(n_words)]
    # distinct only (random collisions possible at short lengths)
    words = sorted(set(words))
    ranks = np.arange(1, len(words) + 1)
    p = (1.0 / ranks) / (1.0 / ranks).sum()

    pieces: set[str] = set()
    for w in words:
        cuts = sorted(
            set(rng.integers(1, len(w), size=int(rng.integers(1, 4))).tolist())
            if len(w) > 1
            else []
        )
        start = 0
        for b in cuts + [len(w)]:
            piece = w[start:b]
            pieces.add(piece if start == 0 else "##" + piece)
            start = b

    chunks = []
    total = 0
    warr = np.array(words)
    while total < size_chars:
        draw = warr[rng.choice(len(words), size=4096, p=p)]
        line = " ".join(draw.tolist())
        chunks.append(line)
        total += len(line) + 1
    text = " ".join(chunks)[:size_chars]
    # The trailing cut can leave a word the vocab does not cover: it UNKs,
    # and the oracle defines the expected output either way.
    return text.rstrip(), sorted(pieces)


def drop_short_continuation(lines: list[str]) -> list[str]:
    """The spaced regime's negative vocabulary: the first `##x` piece
    erased, a frequently used continuation, so the tail goes UNK-heavy."""
    for i, ln in enumerate(lines):
        if ln.startswith("##") and len(ln) == 3:
            return lines[:i] + lines[i + 1:]
    return list(lines)


def single_unit(text_len: int, parts: int):
    """Regime 1 (the JAX test's test_reference_shape_single_unit): (text
    bytes, positive lines, negative lines)."""
    rng = np.random.default_rng(SEED)
    s = random_string(rng, text_len)
    split = random_split(s, rng, parts)
    return s.encode(), split, split[1:]


def spaced(size_chars: int):
    """Regime 2 (the JAX test's test_spaced_device_paths): (text bytes,
    positive lines, negative lines)."""
    text, lines = spaced_corpus_and_vocab(np.random.default_rng(SEED), size_chars)
    return text.encode(), lines, drop_short_continuation(lines)


def mid_scale(text_lens=(100_000, 500_000)):
    """The reference's 100k-1M sweep (the JAX test's
    test_reference_mid_scale_matrix): one generator for all lengths, in
    order, each cut into min(30,000, len // 10) parts.  Yields (text_len,
    text bytes, positive lines, negative lines)."""
    rng = np.random.default_rng(SEED)
    for text_len in text_lens:
        s = random_string(rng, text_len)
        split = random_split(s, rng, min(30_000, text_len // 10))
        yield text_len, s.encode(), split, split[1:]

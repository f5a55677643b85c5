"""Synthetic Wikipedia-shaped text and a bert-base-cased-shaped vocab, from a seed.

A frozen, vectorised copy of `wordpiece_tpu_torch/bench/corpus.py`'s
`make_corpus` (en) and `make_vocab_bert`, with the number of word types
and the Zipf exponent as parameters.  The upstream harness tokenizes
linguatools Wikipedia dumps with bert-base-cased's vocab; without a
network, the text is drawn instead: sentences of 8-17 words, words of
1-16 letters at English letter frequencies, word types ranked by a Zipf
law, punctuation as the original generator places it.  The sentences are
assembled with numpy in blocks, so a 40 MB pool takes about a second and
nothing is cached on disk.

Nothing here imports the program: the benchmark's yardstick stays fixed
while the program changes.
"""

from __future__ import annotations

import numpy as np

LETTERS = np.frombuffer(b"etaoinshrdlcumwfgypbvkjxqz", dtype=np.uint8)
# Roughly English letter frequencies (the original generator's table).
LETTER_FREQ = np.array([12.7, 9.1, 8.2, 7.5, 7.0, 6.7, 6.3, 6.1, 6.0, 4.3, 4.0, 2.8, 2.8,
                        2.4, 2.4, 2.2, 2.0, 2.0, 1.9, 1.5, 1.0, 0.8, 0.2, 0.15, 0.1, 0.07])
PUNCT = [",", ".", "!", "?", ";", "-", ":"]

# Streams drawn from one --seed; each purpose has its own.
STREAM_WORDS, STREAM_POOL, STREAM_VOCAB_SAMPLE, STREAM_DOCS, STREAM_CHECK = range(5)


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """The generator of one purpose, from a seed of any size or sign."""
    return np.random.default_rng([int(seed) & (2**64 - 1), stream])


class WordTypes:
    """`n` word types: letters flat in `data`, word i at offs[i]:offs[i+1].
    Types may repeat (short words collide), as in the original list."""

    def __init__(self, rng: np.random.Generator, n: int):
        p = LETTER_FREQ / LETTER_FREQ.sum()
        lens = np.clip(rng.poisson(4.7, size=n) + 1, 1, 16)
        self.data = LETTERS[rng.choice(LETTERS.shape[0], size=int(lens.sum()), p=p)]
        self.offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lens, out=self.offs[1:])

    @property
    def n(self) -> int:
        return self.offs.shape[0] - 1

    def word(self, i: int) -> str:
        return self.data[self.offs[i] : self.offs[i + 1]].tobytes().decode("ascii")


class ZipfRanks:
    """Draws word-type indices with P(rank r) proportional to 1/r**exponent:
    the inverse of the distribution function, started from a guide table
    of 2**20 cells so that each draw reads a few entries."""

    GUIDE = 1 << 20

    def __init__(self, n: int, exponent: float):
        p = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** exponent
        self.cdf = np.cumsum(p)
        self.cdf /= self.cdf[-1]
        self.n = n
        cells = np.arange(self.GUIDE, dtype=np.float64) / self.GUIDE
        self.guide = np.searchsorted(self.cdf, cells, side="right")

    def draw(self, rng: np.random.Generator, size: int) -> np.ndarray:
        u = rng.random(size)
        idx = self.guide[(u * self.GUIDE).astype(np.int64)]
        while True:  # the first index whose cdf exceeds u
            ahead = np.flatnonzero(self.cdf[np.minimum(idx, self.n - 1)] <= u)
            if ahead.size == 0:
                return np.minimum(idx, self.n - 1)
            idx[ahead] += 1


def make_text(
    rng: np.random.Generator, words: WordTypes, size_bytes: int, exponent: float,
    *, block_sentences: int = 50_000,
) -> tuple[bytes, np.ndarray]:
    """`size_bytes` of text and the count of each word type in it.

    Each line is one sentence: k (8-17) words joined by spaces; with
    probability 0.6 one punctuation mark from PUNCT stands as its own
    word at a position 1..k-1; the line ends in ",", "." or "!" and a
    newline.  The text is cut at `size_bytes`, so its last word may be
    cut short (it is not counted)."""
    ranks = ZipfRanks(words.n, exponent)
    n_tok = words.n + len(PUNCT)
    lens = np.concatenate([np.diff(words.offs), np.ones(len(PUNCT), np.int64)])
    width = int(lens.max()) + 2
    # Each token's bytes and a space, in a row of `width` bytes.
    rows = np.zeros((n_tok, width), dtype=np.uint8)
    col = np.arange(width)
    in_word = col[None, :] < lens[:words.n, None]
    rows[:words.n][in_word] = words.data
    rows[words.n:, 0] = np.frombuffer("".join(PUNCT).encode(), np.uint8)
    rows[np.arange(n_tok), lens] = 32
    final = np.frombuffer(b",.!", np.uint8)
    counts = np.zeros(words.n, dtype=np.int64)
    blocks: list[bytes] = []
    total = 0
    while total < size_bytes:
        s = block_sentences
        k = rng.integers(8, 18, size=s)
        draw = ranks.draw(rng, int(k.sum()))
        ins = rng.random(size=s) < 0.6
        at = rng.integers(1, k)  # the punctuation's place among the words
        pmark = rng.integers(0, len(PUNCT), size=s)
        fin = final[rng.integers(0, 3, size=s)]

        m = k + ins  # elements a sentence
        e_start = np.zeros(s, dtype=np.int64)
        np.cumsum(m[:-1], out=e_start[1:])
        w_start = np.zeros(s, dtype=np.int64)
        np.cumsum(k[:-1], out=w_start[1:])
        sent = np.repeat(np.arange(s), m)
        pos = np.arange(sent.shape[0]) - e_start[sent]
        is_p = ins[sent] & (pos == at[sent])
        widx = pos - (ins[sent] & (pos > at[sent]))
        tok = np.where(is_p, words.n + pmark[sent], draw[w_start[sent] + widx])

        mat = rows[tok]
        tl = lens[tok]
        ends = e_start + m - 1  # each sentence's last element
        mat[ends, tl[ends]] = fin
        mat[ends, tl[ends] + 1] = 10
        out_len = tl + 1
        out_len[ends] += 1
        out = mat[col[None, :] < out_len[:, None]]

        n_out = out.shape[0]
        keep = min(n_out, size_bytes - total)
        whole = ~is_p & (np.cumsum(out_len) - out_len + tl <= keep)
        counts += np.bincount(tok[whole], minlength=n_tok)[: words.n]
        blocks.append(out[:keep].tobytes())
        total += keep
    return b"".join(blocks), counts


def make_vocab_bert(words: WordTypes, counts: np.ndarray, chars: list[str],
                    vocab_size: int = 28996) -> list[str]:
    """bert-base-cased-SHAPED WordPiece vocab (the port's `make_vocab_bert`,
    vectorised): 28,996 entries, 5 specials and 100 [unusedN] slots, every
    character of the training text in bare and ## form, a ~22%
    ##-continuation share and per-length quotas after bert's token
    lengths; the pieces themselves are the training text's most frequent
    prefixes and (at a quarter weight) inner substrings, ties in the order
    the original's loop first met them.  `counts` is each word type's
    count in the training text and `chars` its characters; the original
    split the text on punctuation and spaces to find the same counts.

    A piece is keyed by two int64s, 5 bits a letter: its first 8 letters,
    then the next 8 and whether it is a ## piece."""
    width = 16
    lens = np.diff(words.offs)
    mat = np.zeros((words.n, width), dtype=np.uint8)
    mat[np.arange(width)[None, :] < lens[:, None]] = words.data
    code = np.zeros(256, dtype=np.int64)
    code[LETTERS] = np.arange(1, 27)
    cmat = np.concatenate([code[mat], np.zeros((words.n, 1), np.int64)], axis=1)

    def grow(hi, lo, letter, j):
        if j < 8:
            return hi | (letter << (5 * (7 - j))), lo
        return hi, lo | (letter << (5 * (15 - j)))

    # The distinct words met, in the order of their first type (the
    # original's Counter of words), with their summed counts.
    used = np.flatnonzero(counts)
    hi = np.zeros(used.shape[0], np.int64)
    lo = np.zeros(used.shape[0], np.int64)
    for j in range(width):
        hi, lo = grow(hi, lo, cmat[used, j], j)
    order = np.lexsort((used, lo, hi))
    new = np.ones(order.shape[0], dtype=bool)
    new[1:] = (np.diff(hi[order]) != 0) | (np.diff(lo[order]) != 0)
    first = np.minimum.reduceat(used[order], np.flatnonzero(new))
    wcount = np.bincount(np.cumsum(new) - 1, weights=counts[used][order])
    by_first = np.argsort(first, kind="stable")
    wrow, wcount = first[by_first], wcount[by_first]
    wlen, wc = lens[wrow], cmat[wrow]

    # Every (word, start, length, kind) piece, numbered in the original's
    # loop order: prefixes by length, then inner substrings by start and
    # length (at most 14 letters).
    per_word = width + (width - 1) * 14
    rows_all = np.arange(wrow.shape[0])
    parts = []  # (rows, start, length, cont, hi, lo, seq, weight)
    hi = np.zeros(wrow.shape[0], np.int64)
    lo = np.zeros(wrow.shape[0], np.int64)
    for l in range(1, width + 1):
        hi, lo = grow(hi, lo, wc[:, l - 1], l - 1)
        r = rows_all[wlen >= l]
        parts.append((r, 0, l, 0, hi[r], lo[r], r * per_word + (l - 1), wcount[r]))
    for st in range(1, width):
        hi = np.zeros(wrow.shape[0], np.int64)
        lo = np.zeros(wrow.shape[0], np.int64)
        for l in range(1, 15):
            hi, lo = grow(hi, lo, wc[:, min(st + l - 1, width)], l - 1)
            r = rows_all[wlen - st >= l]
            parts.append((r, st, l, 1, hi[r], lo[r],
                          r * per_word + width + (st - 1) * 14 + (l - 1), wcount[r] / 4))
    sizes = [p[0].shape[0] for p in parts]
    p_row = np.concatenate([p[0] for p in parts])
    p_start = np.repeat([p[1] for p in parts], sizes)
    p_len = np.repeat([p[2] for p in parts], sizes)
    p_cont = np.repeat([p[3] for p in parts], sizes)
    p_hi = np.concatenate([p[4] for p in parts])
    p_lo = (np.concatenate([p[5] for p in parts]) << 1) | p_cont
    p_seq = np.concatenate([p[6] for p in parts])
    p_wt = np.concatenate([p[7] for p in parts])

    order = np.lexsort((p_lo, p_hi))
    new = np.ones(order.shape[0], dtype=bool)
    new[1:] = (np.diff(p_hi[order]) != 0) | (np.diff(p_lo[order]) != 0)
    starts = np.flatnonzero(new)
    total = np.add.reduceat(p_wt[order], starts)
    seq = np.minimum.reduceat(p_seq[order], starts)
    ranked = order[starts][np.lexsort((seq, -total))]  # most_common's order

    def piece(i: int) -> str:
        r, s = wrow[p_row[i]], int(p_start[i])
        text = mat[r, s : s + int(p_len[i])].tobytes().decode("ascii")
        return "##" + text if p_cont[i] else text

    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    vocab += [f"[unused{i}]" for i in range(100)]
    seen = set(vocab)
    punct = [",", ".", "!", "?", ";", "-", ":", "'", '"', "(", ")", "/"]
    for cand in punct + chars + ["##" + ch for ch in chars if ch not in punct]:
        if cand not in seen:
            vocab.append(cand)
            seen.add(cand)
    # Only one-letter pieces can be among those already in.
    one = ranked[p_len[ranked] == 1]
    ranked = ranked[~np.isin(ranked, one[[piece(int(i)) in seen for i in one]])]

    prefix_hist = [0.02, 0.04, 0.08, 0.12, 0.14, 0.14, 0.13, 0.11,
                   0.08, 0.06, 0.04, 0.02, 0.01, 0.01]
    cont_hist = [0.15, 0.25, 0.20, 0.15, 0.10, 0.07, 0.04, 0.02,
                 0.01, 0.005, 0.005, 0.0, 0.0, 0.0]
    remaining = vocab_size - len(vocab)
    n_cont = int(remaining * 0.22)
    n_prefix = remaining - n_cont
    hist = np.array([prefix_hist, cont_hist])
    quota = np.floor(np.array([n_prefix, n_cont])[:, None] * hist).astype(np.int64)
    # The original walks the ranked pieces once: a piece is taken while
    # its kind and length (14 and over as one) have quota left, and the
    # quotas sum to no more than the room, so the walk never stops early;
    # then the passed-over pieces fill the rest in rank order.
    cat = p_cont[ranked] * 14 + np.minimum(p_len[ranked], 14) - 1
    by_cat = np.argsort(cat, kind="stable")
    cat_first = np.searchsorted(cat[by_cat], np.arange(28))
    rank_in_cat = np.empty(ranked.shape[0], np.int64)
    rank_in_cat[by_cat] = np.arange(ranked.shape[0]) - cat_first[cat[by_cat]]
    within = rank_in_cat < quota.reshape(-1)[cat]
    room = max(vocab_size - len(vocab) - int(within.sum()), 0)
    chosen = np.concatenate([ranked[within], ranked[~within][:room]])
    return vocab + [piece(int(i)) for i in chosen]


class Corpus:
    """One seed's pool of text and the vocab built from a training sample
    of the same law drawn apart from it (`spec`: a traffic mix's "corpus")."""

    def __init__(self, spec: dict, seed: int, vocab_size: int):
        words = WordTypes(rng_for(seed, STREAM_WORDS), int(spec["word_types"]))
        exponent = float(spec["zipf_exponent"])
        self.pool, _ = make_text(rng_for(seed, STREAM_POOL), words,
                                 int(spec["pool_bytes"]), exponent)
        sample, counts = make_text(rng_for(seed, STREAM_VOCAB_SAMPLE), words,
                                   int(spec["vocab_sample_bytes"]), exponent)
        chars = sorted(set(sample.decode("ascii")) - set(" \n"))
        self.vocab_lines = make_vocab_bert(words, counts, chars, vocab_size)

"""Synthetic Wikipedia-shaped text and a bert-shaped vocab, from a seed.

A frozen, vectorised copy of `wordpiece_tpu_torch/bench/corpus.py`'s
`make_corpus` (en) and `make_vocab_bert`, with the number of word types
and the Zipf exponent as parameters, and three more languages.  The
upstream harness tokenizes linguatools Wikipedia dumps in en, ru, ja and
zh with bert's vocabs; without a network, the text is drawn instead, in
the shapes of each dump, lower-case.  Each language's text is a sentence
frame filled with elements drawn from one law over the running text:

- en: sentences of 8-17 words, words of 1-16 letters at English letter
  frequencies, punctuation as the original generator places it;
- ru: the same frame, words of 1-16 Cyrillic letters (а-я, ё), 2 bytes a
  letter, their letters and lengths split over the running words by the
  published letter frequencies and 1 + poisson(5.2);
- zh: sentences of 8-17 elements with no spaces, "，" inside and "。" at
  the end; an element is one ideograph, drawn by the published coverage
  of the common characters over the 8,105 of the 通用规范汉字表, or a
  Latin word (en's letters and law) or a number of 1-4 digits;
- ja: sentences of 8-17 phrases with no spaces, "、" inside and "。" at
  the end; a phrase is a stem of 1-3 kanji (drawn one by one over the
  6,355 of JIS X 0208) or a katakana word, then 0-4 hiragana, or a Latin
  word or a number.  Kana and both marks are not spacing characters, so a
  hiragana tail and the katakana words after it join into one unit,
  which can be longer than the vocab's longest piece.

The reference makes each CJK ideograph a unit of its own, so the
ideographs are drawn one by one where the running text holds them: a
word type holds a slot for each, and `Language.text` fills the slots.
Everything else is drawn as word types ranked by a law; every sentence
ends in a newline.  The sentences are assembled with numpy in blocks, so
a 40 MB pool takes a few seconds and nothing is cached on disk.

Nothing here imports the program: the benchmark's yardstick stays fixed
while the program changes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .reference import classes

LANGS = ("en", "ru", "zh", "ja")
LETTERS = np.frombuffer(b"etaoinshrdlcumwfgypbvkjxqz", dtype=np.uint8)
# Roughly English letter frequencies (the original generator's table).
LETTER_FREQ = np.array([12.7, 9.1, 8.2, 7.5, 7.0, 6.7, 6.3, 6.1, 6.0, 4.3, 4.0, 2.8, 2.8,
                        2.4, 2.4, 2.2, 2.0, 2.0, 1.9, 1.5, 1.0, 0.8, 0.2, 0.15, 0.1, 0.07])
PUNCT = [",", ".", "!", "?", ";", "-", ":"]
CYRILLIC = np.array([ord(c) for c in "оеаинтсрвлкмдпуяыьгзбчйхжшюцщэфъё"])
# Russian letter frequencies, in % of the letters of running text: the table
# of ru.wikipedia's article "Частотность" (counted over the Russian National
# Corpus), as published; cited without network access to check it.
CYRILLIC_FREQ = np.array([10.97, 8.45, 8.01, 7.35, 6.70, 6.26, 5.47, 4.73, 4.54, 4.40, 3.49, 3.21,
                          2.98, 2.81, 2.62, 2.01, 1.90, 1.74, 1.70, 1.65, 1.59, 1.44, 1.21, 0.97,
                          0.94, 0.73, 0.64, 0.48, 0.36, 0.32, 0.26, 0.04, 0.04])
IDEOGRAPHS = (0x4E00, 0x9FFF)
HIRAGANA = (0x3041, 0x3096)
KATAKANA = (0x30A1, 0x30FA)
# A word type's place for an ideograph drawn where the running text holds
# it: a private-use codepoint, three bytes in UTF-8 as every ideograph of
# the block, and the only codepoint of the text whose lead byte is 0xEE.
SLOT = 0xE000
SLOT_LEAD = 0xEE

# The shapes of ru, zh and ja: the one place they are set, each stated over
# the running text.  A mix gives its language, word_types (the types of
# each kind of word), zipf_exponent (their law) and sizes.  Each number
# names its source (the document; the table or section; the figure as
# published; types or running text) or is marked guessed: a mix is fit to
# be a cell only when every number it uses has a source (PERF.md §7).
RU_LENGTH_POISSON = 5.2  # guessed: running words of 1 + poisson(5.2) letters, at most 16

# zh ideographs: (characters, share of the running ideographs) of each tier.
# The inventory: the 通用规范汉字表 (State Council, 2013), 8,105 characters
# in tiers of 3,500, 3,000 and 1,605.  The shares: the 现代汉语常用字表
# (State Language Commission and State Education Commission, 1988), its note
# on coverage: the 2,500 常用字 cover 97.97% of running text, the 1,000
# 次常用字 1.51%, the 3,500 together 99.48% (running text, characters); the
# 0.52% left falls on the 2013 table's other 4,605.  Assumed: the 1988
# table's 3,500 are the 2013 table's first 3,500 ranks; the characters
# themselves are a draw from the block, not the tables' own.
ZH_TIERS = ((2500, 0.9797), (1000, 0.0151), (4605, 0.0052))
# ja kanji: the inventory of JIS X 0208:1997, 6,355 kanji (level 1 2,965,
# level 2 3,390).  guessed: one tier, for no published coverage figure is
# named here.
JA_KANJI_TIERS = ((6355, 1.0),)
TIER_ZIPF_EXPONENT = 1.0  # guessed: the order inside a tier, P(rank r) ~ 1/r
JA_KANJI_LEN_MIX = [0.35, 0.5, 0.15]  # guessed: shares of kanji stems of 1-3 kanji
JA_TAIL_MIX = [0.2, 0.3, 0.25, 0.15, 0.1]  # guessed: shares of tails of 0-4 hiragana
JA_KATAKANA_SHARE = 0.25  # guessed: the running phrases with a katakana stem
JA_KATAKANA_LEN = (2, 8)  # guessed: its length, each alike
KANA_ZIPF_EXPONENT = 1.0  # guessed: the kana of a type, by 1/rank over the block in a drawn order
# zh and ja: the shares of the running elements (zh: an ideograph, ja: a
# phrase, or either a Latin word or a number) that are Latin words, at en's
# letters and law, and numbers of 1-4 digits, each length and digit alike.
LATIN_SHARE, DIGIT_SHARE = 0.016, 0.010  # guessed, all of it
# The word types and law of a multilingual sample's languages other than
# the mix's own: the en mix's.
SAMPLE_WORD_TYPES, SAMPLE_ZIPF_EXPONENT = 100_000, 1.0

# Streams drawn from one --seed; each purpose has its own.
STREAM_WORDS, STREAM_POOL, STREAM_VOCAB_SAMPLE, STREAM_DOCS, STREAM_CHECK = range(5)


def rng_for(seed: int, stream: int, *more: int) -> np.random.Generator:
    """The generator of one purpose, from a seed of any size or sign."""
    return np.random.default_rng([int(seed) & (2**64 - 1), stream, *more])


def utf8(cps: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(the UTF-8 bytes of BMP codepoints, each codepoint's byte count)."""
    cps = np.asarray(cps, dtype=np.uint32)
    data = np.frombuffer(cps.astype("<u4").tobytes().decode("utf-32-le").encode("utf-8"), np.uint8)
    return data, np.where(cps < 0x80, 1, np.where(cps < 0x800, 2, 3))


class WordTypes:
    """`n` word types in UTF-8: bytes flat in `data`, word i at
    offs[i]:offs[i+1].  Types may repeat (short words collide), as in the
    original list.  `WordTypes(rng, n)` draws the en types."""

    def __init__(self, rng: np.random.Generator, n: int):
        p = LETTER_FREQ / LETTER_FREQ.sum()
        lens = np.clip(rng.poisson(4.7, size=n) + 1, 1, 16)
        self._set(LETTERS[rng.choice(LETTERS.shape[0], size=int(lens.sum()), p=p)], lens)

    @classmethod
    def of_codepoints(cls, cps: np.ndarray, lens: np.ndarray) -> "WordTypes":
        """Word i: the next lens[i] codepoints of `cps`."""
        words = cls.__new__(cls)
        data, nbytes = utf8(cps)
        starts = np.zeros(lens.shape[0], np.int64)
        np.cumsum(lens[:-1], out=starts[1:])
        words._set(data, np.add.reduceat(nbytes, starts))
        return words

    @classmethod
    def joined(cls, parts: list["WordTypes"]) -> "WordTypes":
        """The types of each part in turn."""
        words = cls.__new__(cls)
        words._set(np.concatenate([p.data for p in parts]), np.concatenate([np.diff(p.offs) for p in parts]))
        return words

    def _set(self, data: np.ndarray, lens: np.ndarray) -> None:
        self.data = data
        self.offs = np.zeros(lens.shape[0] + 1, dtype=np.int64)
        np.cumsum(lens, out=self.offs[1:])

    @property
    def n(self) -> int:
        return self.offs.shape[0] - 1

    def word(self, i: int) -> str:
        return self.data[self.offs[i] : self.offs[i + 1]].tobytes().decode("utf-8")


def zipf_weights(n: int, exponent: float) -> np.ndarray:
    """1/rank**exponent for ranks 1..n."""
    return 1.0 / np.arange(1, n + 1, dtype=np.float64) ** exponent


def tiered_weights(tiers, exponent: float) -> np.ndarray:
    """Weights of ranks 1..sum(n) for tiers of (n, share): each tier holds
    its share of the draws, spread over its ranks by 1/rank**exponent."""
    w = zipf_weights(sum(n for n, _ in tiers), exponent)
    edges = np.cumsum([0] + [n for n, _ in tiers])
    for (_, share), a, b in zip(tiers, edges[:-1], edges[1:]):
        w[a:b] *= share / w[a:b].sum()
    return w


class Ranks:
    """Draws indices 0..n-1 with P(i) proportional to weights[i]: the
    inverse of the distribution function, started from a guide table of
    2**20 cells so that each draw reads a few entries; a draw still short
    after WALK steps (many light types in one cell) is searched for."""

    GUIDE = 1 << 20
    WALK = 8

    def __init__(self, weights: np.ndarray):
        self.cdf = np.cumsum(weights)
        self.cdf /= self.cdf[-1]
        self.n = weights.shape[0]
        cells = np.arange(self.GUIDE, dtype=np.float64) / self.GUIDE
        self.guide = np.searchsorted(self.cdf, cells, side="right")

    @classmethod
    def zipf(cls, n: int, exponent: float) -> "Ranks":
        return cls(zipf_weights(n, exponent))

    def draw(self, rng: np.random.Generator, size: int) -> np.ndarray:
        u = rng.random(size)
        idx = self.guide[(u * self.GUIDE).astype(np.int64)]
        ahead = np.flatnonzero(self.cdf[np.minimum(idx, self.n - 1)] <= u)
        for _ in range(self.WALK):  # the first index whose cdf exceeds u
            if ahead.size == 0:
                return np.minimum(idx, self.n - 1)
            idx[ahead] += 1
            ahead = ahead[self.cdf[np.minimum(idx[ahead], self.n - 1)] <= u[ahead]]
        idx[ahead] = np.searchsorted(self.cdf, u[ahead], side="right")
        return np.minimum(idx, self.n - 1)


def _draw_from(rng: np.random.Generator, block: tuple[int, int], n: int) -> np.ndarray:
    """`n` distinct codepoints of a block, in an order drawn from `rng`."""
    return block[0] + rng.choice(block[1] - block[0] + 1, size=n, replace=False)


def _mixture(kinds: list[tuple[WordTypes, np.ndarray, float]]) -> tuple[WordTypes, Ranks]:
    """The word types of several kinds and one law over them: a kind
    (words, weights, share) holds `share` of the running draws, spread
    over its types by its weights."""
    words = WordTypes.joined([k[0] for k in kinds])
    return words, Ranks(np.concatenate([share * w / w.sum() for _, w, share in kinds]))


def _numbers() -> tuple[WordTypes, np.ndarray]:
    """Every number of 1-4 digits, leading zeros too, and their weights:
    each length alike, each number of a length alike."""
    parts, weights = [], []
    for k in range(1, 5):
        digits = (np.arange(10**k)[:, None] // 10 ** np.arange(k - 1, -1, -1)[None, :]) % 10
        parts.append(WordTypes.of_codepoints((ord("0") + digits).ravel(), np.full(10**k, k)))
        weights.append(np.full(10**k, 0.1**k))
    return WordTypes.joined(parts), np.concatenate(weights)


def _ascii_kinds(rng: np.random.Generator, n: int, exponent: float) -> list:
    """The ASCII kinds of zh and ja: `n` Latin word types (en's) under the
    mix's law, and the numbers."""
    numbers, weights = _numbers()
    return [(WordTypes(rng, n), zipf_weights(n, exponent), LATIN_SHARE), (numbers, weights, DIGIT_SHARE)]


def _stratified(rng: np.random.Generator, weights: np.ndarray, probs: np.ndarray) -> np.ndarray:
    """A category for each item, such that the items' weights split among
    the categories as `probs` does: the items in a drawn order, each taking
    the category in which the middle of its share of the cumulative weight
    falls.  So a share stated over the running text holds in it, where
    drawing each item's category alone would leave the few heaviest items
    to move it by points."""
    order = rng.permutation(weights.shape[0])
    w = weights[order]
    mid = (np.cumsum(w) - w / 2) / w.sum()
    cat = np.empty(weights.shape[0], np.int64)
    cat[order] = np.minimum(np.searchsorted(np.cumsum(probs) / probs.sum(), mid, side="right"), probs.shape[0] - 1)
    return cat


def ru_words(rng: np.random.Generator, n: int, exponent: float) -> WordTypes:
    """`n` word types under Zipf `exponent`, their lengths and letters
    split over the running words by RU_LENGTH_POISSON and CYRILLIC_FREQ."""
    k = np.arange(15)
    pmf = np.exp(k * np.log(RU_LENGTH_POISSON) - RU_LENGTH_POISSON - np.cumsum(np.log(np.maximum(k, 1))))
    weights = zipf_weights(n, exponent)
    lens = 1 + _stratified(rng, weights, np.append(pmf, max(1.0 - pmf.sum(), 0.0)))
    letters = _stratified(rng, np.repeat(weights, lens), CYRILLIC_FREQ)
    return WordTypes.of_codepoints(CYRILLIC[letters], lens)


def ja_phrases(rng: np.random.Generator, n: int, katakana: bool, kata: np.ndarray,
               hira: np.ndarray) -> WordTypes:
    """`n` phrase types: a stem of 1-3 kanji slots or a katakana word, then
    a hiragana tail; the kana of each kind by KANA_ZIPF_EXPONENT."""
    kmix, tmix = np.asarray(JA_KANJI_LEN_MIX), np.asarray(JA_TAIL_MIX)
    if katakana:
        stem = rng.integers(JA_KATAKANA_LEN[0], JA_KATAKANA_LEN[1] + 1, size=n)
    else:
        stem = rng.choice(kmix.shape[0], size=n, p=kmix / kmix.sum()) + 1
    lens = stem + rng.choice(tmix.shape[0], size=n, p=tmix / tmix.sum())
    starts = np.zeros(n, np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    word = np.repeat(np.arange(n), lens)
    in_stem = np.arange(word.shape[0]) - starts[word] < stem[word]
    cps = np.full(word.shape[0], SLOT, np.int64)  # a kanji stem keeps its slots
    for where, chars in ((in_stem, kata), (~in_stem, hira)) if katakana else ((~in_stem, hira),):
        cps[where] = chars[Ranks.zipf(chars.shape[0], KANA_ZIPF_EXPONENT).draw(rng, int(where.sum()))]
    return WordTypes.of_codepoints(cps, lens)


class Frame(NamedTuple):
    """How a language's sentences are put together: words joined by a space
    or by nothing, one mark of `marks` inside with probability 0.6, one of
    `finals` (all of one byte length) and a newline at the end.  The
    original (en) generator's frame; guessed for ru, zh and ja."""

    spaced: bool
    marks: list[str]
    finals: list[str]


FRAMES = {"en": Frame(True, PUNCT, [",", ".", "!"]), "ru": Frame(True, PUNCT, [",", ".", "!"]),
          "zh": Frame(False, ["，"], ["。"]), "ja": Frame(False, ["、"], ["。"])}


class Language(NamedTuple):
    """What one language's text is drawn from: its frame, word types and
    their law over the running text, and for zh and ja the ideographs (by
    rank) that fill the types' slots one by one, under their own law."""

    frame: Frame
    words: WordTypes
    ranks: Ranks
    ideographs: np.ndarray | None = None
    ideograph_ranks: Ranks | None = None

    def text(self, rng: np.random.Generator, size_bytes: int, *,
             whole_lines: bool = True) -> tuple[bytes, np.ndarray]:
        """`make_text`'s text and counts, each slot filled."""
        text, counts = make_text(rng, self.words, size_bytes, self.ranks, frame=self.frame,
                                 whole_lines=whole_lines)
        if self.ideographs is None:
            return text, counts
        buf = np.frombuffer(text, np.uint8).copy()
        at = np.flatnonzero(buf == SLOT_LEAD)
        data, _ = utf8(self.ideographs[self.ideograph_ranks.draw(rng, at.shape[0])])
        buf[at[:, None] + np.arange(3)[None, :]] = data.reshape(-1, 3)
        return buf.tobytes(), counts


def language(lang: str, n: int, exponent: float, rng: np.random.Generator) -> Language:
    """A language with `n` word types of each kind under Zipf `exponent`."""
    if lang == "en":
        return Language(FRAMES[lang], WordTypes(rng, n), Ranks.zipf(n, exponent))
    if lang == "ru":
        return Language(FRAMES[lang], ru_words(rng, n, exponent), Ranks.zipf(n, exponent))
    tiers = {"zh": ZH_TIERS, "ja": JA_KANJI_TIERS}[lang]
    ideographs = _draw_from(rng, IDEOGRAPHS, sum(t[0] for t in tiers))  # by rank
    own = 1.0 - LATIN_SHARE - DIGIT_SHARE
    if lang == "zh":
        kinds = [(WordTypes.of_codepoints(np.array([SLOT]), np.array([1])), np.ones(1), own)]
    else:
        hira = _draw_from(rng, HIRAGANA, HIRAGANA[1] - HIRAGANA[0] + 1)
        kata = _draw_from(rng, KATAKANA, KATAKANA[1] - KATAKANA[0] + 1)
        kinds = [(ja_phrases(rng, n, katakana, kata, hira), zipf_weights(n, exponent), share)
                 for katakana, share in ((False, own - JA_KATAKANA_SHARE), (True, JA_KATAKANA_SHARE))]
    words, ranks = _mixture(kinds + _ascii_kinds(rng, n, exponent))
    return Language(FRAMES[lang], words, ranks, ideographs, Ranks(tiered_weights(tiers, TIER_ZIPF_EXPONENT)))


def make_text(
    rng: np.random.Generator, words: WordTypes, size_bytes: int, ranks: Ranks,
    *, frame: Frame = FRAMES["en"], whole_lines: bool = False, block_sentences: int = 50_000,
) -> tuple[bytes, np.ndarray]:
    """`size_bytes` of text and the count of each word type in it.

    Each line is one sentence: k (8-17) words drawn by `ranks`, joined by spaces where the
    frame says so; with probability 0.6 one mark of the frame stands as
    its own word at a position 1..k-1; the line ends in one of the
    frame's finals and a newline.  The text is cut at `size_bytes`, so
    its last word may be cut short (it is not counted); with
    `whole_lines`, at the last newline before it."""
    marks = [m.encode("utf-8") for m in frame.marks]
    n_tok = words.n + len(marks)
    lens = np.concatenate([np.diff(words.offs), [len(m) for m in marks]]).astype(np.int64)
    finals = np.frombuffer("".join(frame.finals).encode("utf-8"), np.uint8).reshape(len(frame.finals), -1)
    n_fin = finals.shape[1]
    sep = int(frame.spaced)
    width = int(lens.max()) + max(sep, n_fin + 1)
    # Each token's bytes and the separator, in a row of `width` bytes.
    rows = np.zeros((n_tok, width), dtype=np.uint8)
    col = np.arange(width)
    in_word = col[None, :] < lens[:words.n, None]
    rows[:words.n][in_word] = words.data
    for j, m in enumerate(marks):
        rows[words.n + j, : len(m)] = np.frombuffer(m, np.uint8)
    if sep:
        rows[np.arange(n_tok), lens] = 32
    counts = np.zeros(words.n, dtype=np.int64)
    blocks: list[bytes] = []
    total = 0
    while total < size_bytes:
        s = block_sentences
        k = rng.integers(8, 18, size=s)
        draw = ranks.draw(rng, int(k.sum()))
        ins = rng.random(size=s) < 0.6
        at = rng.integers(1, k)  # the mark's place among the words
        pmark = rng.integers(0, len(marks), size=s)
        fin = finals[rng.integers(0, finals.shape[0], size=s)]

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
        for j in range(n_fin):
            mat[ends, tl[ends] + j] = fin[:, j]
        mat[ends, tl[ends] + n_fin] = 10
        out_len = tl + sep
        out_len[ends] = tl[ends] + n_fin + 1
        out = mat[col[None, :] < out_len[:, None]]

        n_out = out.shape[0]
        keep = min(n_out, size_bytes - total)
        if whole_lines and keep < n_out:
            nl = np.flatnonzero(out[:keep] == 10)
            keep = int(nl[-1]) + 1 if nl.size else 0
            size_bytes = total + keep  # the last block
        whole = ~is_p & (np.cumsum(out_len) - out_len + tl <= keep)
        counts += np.bincount(tok[whole], minlength=n_tok)[: words.n]
        blocks.append(out[:keep].tobytes())
        total += keep
    return b"".join(blocks), counts


# bert's token lengths, 1 to 14 and over: shares of the prefix and the ## pieces.
PREFIX_HIST = [0.02, 0.04, 0.08, 0.12, 0.14, 0.14, 0.13, 0.11, 0.08, 0.06, 0.04, 0.02, 0.01, 0.01]
CONT_HIST = [0.15, 0.25, 0.20, 0.15, 0.10, 0.07, 0.04, 0.02, 0.01, 0.005, 0.005, 0.0, 0.0, 0.0]


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

    vocab, seen = _first_lines(chars)
    # Only one-letter pieces can be among those already in.
    one = ranked[p_len[ranked] == 1]
    ranked = ranked[~np.isin(ranked, one[[piece(int(i)) in seen for i in one]])]
    chosen = _by_quota(ranked, p_cont[ranked], p_len[ranked], vocab_size - len(vocab))
    return vocab + [piece(int(i)) for i in chosen]


def _first_lines(chars: list[str]) -> tuple[list[str], set[str]]:
    """The vocab's first lines and their set: 5 specials, 100 [unusedN]
    slots, punctuation, and each character bare and (but punctuation) ##."""
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    vocab += [f"[unused{i}]" for i in range(100)]
    seen = set(vocab)
    punct = [",", ".", "!", "?", ";", "-", ":", "'", '"', "(", ")", "/"]
    for cand in punct + chars + ["##" + ch for ch in chars if ch not in punct]:
        if cand not in seen:
            vocab.append(cand)
            seen.add(cand)
    return vocab, seen


def _by_quota(ranked: np.ndarray, cont: np.ndarray, length: np.ndarray, remaining: int) -> np.ndarray:
    """The pieces of `ranked` (each a ## piece or not, of a length) that
    fill `remaining` lines: ~22% of them ## pieces, each kind under
    per-length quotas after bert's token lengths."""
    n_cont = int(remaining * 0.22)
    quota = np.floor(np.array([remaining - n_cont, n_cont])[:, None]
                     * np.array([PREFIX_HIST, CONT_HIST])).astype(np.int64)
    # The original walks the ranked pieces once: a piece is taken while
    # its kind and length (14 and over as one) have quota left, and the
    # quotas sum to no more than the room, so the walk never stops early;
    # then the passed-over pieces fill the rest in rank order.
    cat = cont * 14 + np.minimum(length, 14) - 1
    by_cat = np.argsort(cat, kind="stable")
    cat_first = np.searchsorted(cat[by_cat], np.arange(28))
    rank_in_cat = np.empty(ranked.shape[0], np.int64)
    rank_in_cat[by_cat] = np.arange(ranked.shape[0]) - cat_first[cat[by_cat]]
    within = rank_in_cat < quota.reshape(-1)[cat]
    room = max(remaining - int(within.sum()), 0)
    return np.concatenate([ranked[within], ranked[~within][:room]])


# Pieces are counted over the first UNIT_CAP codepoints of each unit.
UNIT_CAP = 32
LONGEST_PREFIX, LONGEST_CONT = 16, 14


def _pack(codes: np.ndarray, bits: int) -> np.ndarray:
    """Rows of codes (each < 2**bits) as keys: one int64 for up to 63 // bits
    codes, a byte string of several otherwise; equal rows, equal keys."""
    per = 63 // bits
    k = -(-codes.shape[1] // per)
    words = np.zeros((codes.shape[0], k), np.int64)
    for j in range(codes.shape[1]):
        words[:, j // per] |= codes[:, j].astype(np.int64) << (bits * (j % per))
    return words[:, 0] if k == 1 else np.ascontiguousarray(words).view(np.dtype((np.void, 8 * k))).ravel()


def make_vocab_units(sample: bytes, vocab_size: int) -> list[str]:
    """A bert-shaped WordPiece vocab of any script, by `make_vocab_bert`'s
    rules: 5 specials and 100 [unusedN] slots, every character of the
    sample in bare and ## form, then the most frequent pieces, ~22% of
    them ## continuations, under the same per-length quotas.  Pieces are
    counted over units as the reference splits the text: a space,
    punctuation and each CJK ideograph are boundaries, so a unit is a run
    of other characters; each unit gives its prefixes (up to 16
    codepoints, at its count) and its inner substrings (up to 14, at a
    quarter of it), ties in the order the units are first met.  Where the
    pieces do not fill the vocab, CJK ideographs the sample lacks do,
    bare then ##, in codepoint order.  Exactly `vocab_size` distinct
    lines, or ValueError where even those do not fill it."""
    cps = np.frombuffer(sample.decode("utf-8").encode("utf-32-le"), "<u4").astype(np.int64)
    space, spacing = classes(cps)
    vocab, seen = _first_lines([chr(c) for c in np.unique(cps[~space])])

    # The distinct units in the order first met, their counts and codes.
    word = ~spacing
    starts = np.flatnonzero(word & ~np.concatenate([[False], word[:-1]]))
    ends = np.flatnonzero(word & ~np.concatenate([word[1:], [False]])) + 1
    alphabet = np.unique(cps[word])
    bits = max(int(alphabet.shape[0]).bit_length(), 1)
    code = np.zeros(cps.shape[0] + 1, np.int64)
    code[:-1][word] = np.searchsorted(alphabet, cps[word]) + 1
    ulen = np.minimum(ends - starts, UNIT_CAP)
    width = int(ulen.max()) if ulen.size else 1
    col = np.arange(width)
    at = np.where(col[None, :] < ulen[:, None], starts[:, None] + col[None, :], cps.shape[0])
    units = code[at]  # 0 past each unit's end
    _, first, inverse = np.unique(_pack(units, bits), return_index=True, return_inverse=True)
    count = np.bincount(inverse.ravel())
    order = np.argsort(first, kind="stable")
    units, count, ulen = units[first[order]], count[order], ulen[first[order]]
    rows = np.arange(units.shape[0])

    # Each distinct piece of each kind and length: its total weight, its
    # first place in the order the units give them, and one place it is at.
    per_unit = LONGEST_PREFIX + (width - 1) * LONGEST_CONT
    found = []  # (total, seq, cont, length, row, start)

    def gather(cont: int, length: int, places: list[tuple[np.ndarray, int, np.ndarray]]) -> None:
        if not sum(p[0].shape[0] for p in places):
            return
        r = np.concatenate([p[0] for p in places])
        st = np.concatenate([np.full(p[0].shape[0], p[1]) for p in places])
        seq = np.concatenate([p[2] for p in places])
        keys = _pack(units[r[:, None], st[:, None] + np.arange(length)[None, :]], bits)
        _, idx, inv = np.unique(keys, return_index=True, return_inverse=True)
        inv = inv.ravel()
        total = np.bincount(inv, weights=count[r] / (4.0 if cont else 1.0))
        first_seq = np.full(idx.shape[0], np.iinfo(np.int64).max)
        np.minimum.at(first_seq, inv, seq)
        found.append((total, first_seq, np.full(idx.shape[0], cont), np.full(idx.shape[0], length),
                      r[idx], st[idx]))

    for length in range(1, LONGEST_PREFIX + 1):
        r = rows[ulen >= length]
        gather(0, length, [(r, 0, r * per_unit + length - 1)])
    for length in range(1, LONGEST_CONT + 1):
        places = []
        for st in range(1, width):
            r = rows[ulen - st >= length]
            places.append((r, st, r * per_unit + LONGEST_PREFIX + (st - 1) * LONGEST_CONT + length - 1))
        gather(1, length, places)
    cols = [np.concatenate(f) for f in zip(*found)] if found else [np.zeros(0, np.int64)] * 6
    total, seq, p_cont, p_len, p_row, p_start = cols
    ranked = np.lexsort((seq, -total))

    def pieces(idx: np.ndarray) -> list[str]:
        """The pieces at `idx`, spelled from the place each was found: the
        rows' codepoints, each row ended by 0s, decoded at once."""
        col = np.arange(int(p_len[idx].max(initial=0)) + 1)
        inside = col[None, :] < p_len[idx, None]
        codes = units[p_row[idx, None], np.where(inside, p_start[idx, None] + col[None, :], 0)]
        cps = np.where(inside, alphabet[codes - 1], 0).astype("<u4")
        texts = [t for t in cps.tobytes().decode("utf-32-le").split("\0") if t]
        return ["##" + t if c else t for t, c in zip(texts, p_cont[idx])]

    one = ranked[p_len[ranked] == 1]  # only one-codepoint pieces can be in already
    ranked = ranked[~np.isin(ranked, one[np.array([t in seen for t in pieces(one)], dtype=bool)])]
    chosen = _by_quota(ranked, p_cont[ranked], p_len[ranked], vocab_size - len(vocab))
    vocab += pieces(chosen)
    if len(vocab) < vocab_size:
        lacking = [chr(c) for c in range(IDEOGRAPHS[0], IDEOGRAPHS[1] + 1) if chr(c) not in seen]
        vocab += (lacking + ["##" + c for c in lacking])[: vocab_size - len(vocab)]
    if len(vocab) != vocab_size:
        raise ValueError(f"the sample's pieces and the CJK block fill {len(vocab)} of {vocab_size} lines")
    return vocab


class Corpus:
    """One seed's pool of text and the vocab built from a training sample
    drawn apart from it (`spec`: a traffic mix's "corpus": "lang", one of
    LANGS, "word_types", "zipf_exponent", "pool_bytes" and
    "vocab_sample_bytes"); `language` is what the pool is drawn from.

    Without `vocab_sample` the sample is of the mix's language and law
    (for en, `make_vocab_bert` builds the vocab, as it always has).  With
    it (a share of the sample's bytes for each language), the mix's
    language is drawn from the pool's word types and law, each other one
    from SAMPLE_WORD_TYPES types of its own under the same seed, and
    `make_vocab_units` builds the vocab from them all."""

    def __init__(self, spec: dict, seed: int, vocab_size: int, vocab_sample: dict | None = None):
        lang = spec["lang"]
        if lang not in LANGS:
            raise ValueError(f"unknown language {lang!r}; the generator knows {', '.join(LANGS)}")
        self.language = language(lang, int(spec["word_types"]), float(spec["zipf_exponent"]),
                                 rng_for(seed, STREAM_WORDS))
        self.pool, _ = self.language.text(rng_for(seed, STREAM_POOL), int(spec["pool_bytes"]),
                                          whole_lines=lang != "en")
        sample_bytes = int(spec["vocab_sample_bytes"])
        if vocab_sample is None and lang == "en":
            sample, counts = self.language.text(rng_for(seed, STREAM_VOCAB_SAMPLE), sample_bytes,
                                                whole_lines=False)
            chars = sorted(set(sample.decode("ascii")) - set(" \n"))
            self.vocab_lines = make_vocab_bert(self.language.words, counts, chars, vocab_size)
            return
        shares = vocab_sample or {lang: 1.0}
        unknown = set(shares) - set(LANGS)
        if unknown or not all(float(v) > 0 for v in shares.values()):
            raise ValueError(f"vocab_sample: languages of {', '.join(LANGS)} with shares above 0: {shares}")
        whole = sum(float(v) for v in shares.values())
        parts = []
        for i, other in enumerate(LANGS):
            if other not in shares:
                continue
            if other == lang:
                lng = self.language
            else:
                lng = language(other, SAMPLE_WORD_TYPES, SAMPLE_ZIPF_EXPONENT, rng_for(seed, STREAM_WORDS, i + 1))
            part, _ = lng.text(rng_for(seed, STREAM_VOCAB_SAMPLE, i + 1),
                               round(sample_bytes * float(shares[other]) / whole))
            parts.append(part)
        self.vocab_lines = make_vocab_units(b"".join(parts), vocab_size)

"""The traffic generator: deterministic from its seed, documents cut at
spaces, every seed the same sizes, the en text and vocab as they always
were, the ru, zh and ja shapes, and the vectorised vocab builders equal to
the loops they copy."""

import hashlib
import json
import os
import time
from collections import Counter

import control
import numpy as np
import pytest
from conftest import BENCH

from wpbench.corpus import (Corpus, Ranks, WordTypes, language, make_text, make_vocab_bert, make_vocab_units,
                            rng_for, CYRILLIC, CYRILLIC_FREQ, FRAMES, IDEOGRAPHS, LONGEST_CONT, LONGEST_PREFIX,
                            UNIT_CAP)
from wpbench.reference import Reference, classes, is_spacing
from wpbench.traffic import N_DOCS, Documents, size_set

SPEC = {"lang": "en", "word_types": 2000, "zipf_exponent": 1.0, "pool_bytes": 200_000,
        "vocab_sample_bytes": 60_000}
MULTI = {"en": 0.4, "ru": 0.2, "zh": 0.2, "ja": 0.2}


def mix_corpus(lang: str) -> dict:
    with open(os.path.join(BENCH, "traffic", f"wiki-{lang}-10MB.json"), encoding="utf-8") as f:
        return json.load(f)["corpus"]
ARTICLES = {"median_bytes": 3000, "sigma": 1.0, "min_bytes": 200, "max_bytes": 20_000, "sizes": 64}


def loop_vocab(words, counts, chars, vocab_size):
    """The port's make_vocab_bert as written (a Counter loop), from word counts."""
    wc = Counter()
    for i in np.flatnonzero(counts):
        wc[words.word(int(i))] += int(counts[i])
    pieces = Counter()
    for w, c in wc.items():
        for l in range(1, min(len(w), 18) + 1):
            pieces[w[:l]] += c
        for st in range(1, len(w)):
            for l in range(1, min(len(w) - st, 14) + 1):
                pieces["##" + w[st : st + l]] += c / 4
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [f"[unused{i}]" for i in range(100)]
    seen = set(vocab)
    punct = [",", ".", "!", "?", ";", "-", ":", "'", '"', "(", ")", "/"]
    for cand in punct + chars + ["##" + ch for ch in chars if ch not in punct]:
        if cand not in seen:
            vocab.append(cand)
            seen.add(cand)
    prefix_hist = [0.02, 0.04, 0.08, 0.12, 0.14, 0.14, 0.13, 0.11, 0.08, 0.06, 0.04, 0.02, 0.01, 0.01]
    cont_hist = [0.15, 0.25, 0.20, 0.15, 0.10, 0.07, 0.04, 0.02, 0.01, 0.005, 0.005, 0.0, 0.0, 0.0]
    remaining = vocab_size - len(vocab)
    n_cont = int(remaining * 0.22)
    n_prefix = remaining - n_cont
    quota = {}
    for l in range(1, 15):
        quota[(False, l)] = int(n_prefix * prefix_hist[l - 1])
        quota[(True, l)] = int(n_cont * cont_hist[l - 1])
    ranked = [p for p, _ in pieces.most_common() if p not in seen]
    spill = []
    for piece in ranked:
        if len(vocab) >= vocab_size:
            break
        is_cont = piece.startswith("##")
        l = min(len(piece) - (2 if is_cont else 0), 14)
        if quota.get((is_cont, l), 0) > 0:
            quota[(is_cont, l)] -= 1
            vocab.append(piece)
            seen.add(piece)
        else:
            spill.append(piece)
    for piece in spill:
        if len(vocab) >= vocab_size:
            break
        vocab.append(piece)
        seen.add(piece)
    return vocab


def test_same_seed_same_corpus_other_seed_other_corpus():
    a, b = Corpus(SPEC, 2**33 + 5, 3000), Corpus(SPEC, 2**33 + 5, 3000)
    c = Corpus(SPEC, 2**33 + 6, 3000)
    assert a.pool == b.pool and a.vocab_lines == b.vocab_lines
    assert a.pool != c.pool
    assert len(a.pool) == SPEC["pool_bytes"]
    assert len(a.vocab_lines) == len(set(a.vocab_lines))


def test_text_shape_and_counts():
    words = WordTypes(rng_for(7, 0), 500)
    text, counts = make_text(rng_for(7, 1), words, 50_000, Ranks.zipf(words.n, 1.0))
    assert len(text) == 50_000
    lines = text.decode("ascii").split("\n")[:-1]
    for line in lines:
        assert line[-1] in ",.!"
        assert 8 <= len([w for w in line[:-1].split(" ") if w.isalpha()]) <= 17
    found = Counter(w for line in lines for w in line[:-1].split(" ") if w.isalpha())
    want = Counter()
    for i in np.flatnonzero(counts):
        want[words.word(int(i))] += int(counts[i])
    # the counts cover every whole word, the last line's too
    assert not found - want and sum((want - found).values()) <= 17


@pytest.mark.parametrize("seed,types,size,vocab_size", [
    (5, 3000, 300_000, 28996), (7, 3000, 300_000, 2000), (2**40 + 3, 500, 100_000, 1500),
    (9, 50, 20_000, 28996),
])
def test_vectorised_vocab_equals_the_loop(seed, types, size, vocab_size):
    words = WordTypes(rng_for(seed, 0), types)
    text, counts = make_text(rng_for(seed, 2), words, size, Ranks.zipf(words.n, 1.0))
    chars = sorted(set(text.decode("ascii")) - set(" \n"))
    assert make_vocab_bert(words, counts, chars, vocab_size) == loop_vocab(words, counts, chars, vocab_size)


@pytest.mark.parametrize("spec", [{"bytes": 20_000}, ARTICLES], ids=["fixed", "lognormal"])
def test_documents_are_deterministic_and_cut_at_spaces(spec):
    pool = Corpus(SPEC, 11, 2000).pool
    d1, d2 = Documents(spec, pool, 11, 4), Documents(spec, pool, 11, 4)
    assert [d1.doc(i) for i in range(50)] == [d2.doc(i) for i in range(50)]
    for i in range(200):
        s, e = d1.start[i], d1.end[i]
        assert pool[s - 1 : s] in (b" ", b"\n") and pool[e : e + 1] in (b" ", b"\n")
        assert e - s >= min(size_set(spec))
    warm = d1.warmup()
    assert len(warm) == 4 and len(warm[-1]) >= max(size_set(spec))
    assert d1.doc(N_DOCS) == d1.doc(0)


def test_every_seed_sends_the_same_sizes():
    pool = Corpus(SPEC, 3, 2000).pool
    sizes = np.sort(size_set(ARTICLES))
    assert sizes.min() >= 200 and sizes.max() <= 20_000 and abs(np.median(sizes) - 3000) < 100
    firsts = []
    for seed in (3, 4):
        docs = Documents(ARTICLES, pool, seed, 4)
        for block in (0, 1):
            i = np.arange(64 * block, 64 * (block + 1))
            got = np.array(docs.end)[i] - np.array(docs.start)[i]
            # each block sends each size once; the cut at a space adds less than a word
            order = np.argsort(got, kind="stable")
            assert np.all(got[order] >= sizes) and np.all(got[order] - sizes < 20)
        firsts.append(got)
    assert list(firsts[0]) != list(firsts[1])


# sha256(pool)[:16] and sha256("\n".join(vocab lines))[:16] of wiki-en-10MB's
# corpus as the generator made it when it knew en alone.
EN_DIGESTS = {1: ("e44fe69fe6a2342e", "9e811a5634c78c11"), 2: ("17008bc9e9a20133", "89675f34b9c48837")}


@pytest.mark.parametrize("seed", sorted(EN_DIGESTS))
def test_the_en_corpus_is_what_it_was(seed):
    c = Corpus(mix_corpus("en"), seed, 28996)
    got = (hashlib.sha256(c.pool).hexdigest()[:16],
           hashlib.sha256("\n".join(c.vocab_lines).encode()).hexdigest()[:16])
    assert got == EN_DIGESTS[seed]


SMALL = {"pool_bytes": 300_000, "vocab_sample_bytes": 100_000}
BYTES_PER_CODEPOINT = {"ru": (1.7, 2.0), "zh": (2.6, 2.85), "ja": (2.75, 2.95)}


def in_script(lang: str, cps: np.ndarray) -> np.ndarray:
    """The codepoints a language's text may hold, besides spaces and newlines."""
    marks = [ord(c) for f in [FRAMES[lang]] for c in f.marks + f.finals]
    ok = np.isin(cps, marks)
    if lang == "ru":
        return ok | ((cps >= 0x430) & (cps <= 0x44F)) | (cps == 0x451)
    ok |= (cps >= IDEOGRAPHS[0]) & (cps <= IDEOGRAPHS[1])
    ok |= ((cps >= ord("a")) & (cps <= ord("z"))) | ((cps >= ord("0")) & (cps <= ord("9")))
    if lang == "ja":
        ok |= ((cps >= 0x3041) & (cps <= 0x3096)) | ((cps >= 0x30A1) & (cps <= 0x30FA))
    return ok


def unit_lengths(cps: np.ndarray) -> np.ndarray:
    """The codepoints of each unit, as the reference splits the text: a
    punctuation mark or a CJK ideograph alone, else a run between them."""
    space, spacing = classes(cps)
    word = ~spacing
    starts = np.flatnonzero(word & ~np.concatenate([[False], word[:-1]]))
    ends = np.flatnonzero(word & ~np.concatenate([word[1:], [False]])) + 1
    return np.concatenate([ends - starts, np.ones(int((spacing & ~space).sum()), np.int64)])


@pytest.mark.parametrize("lang", ["ru", "zh", "ja"])
def test_a_language_has_its_shapes(lang):
    spec = {**mix_corpus(lang), **SMALL}
    t0 = time.process_time()
    c = Corpus(spec, 2**33 + 9, 28996)
    build_s = time.process_time() - t0
    again = Corpus(spec, 2**33 + 9, 28996)
    assert c.pool == again.pool and c.vocab_lines == again.vocab_lines
    assert c.pool != Corpus(spec, 2**33 + 10, 28996).pool
    text = c.pool.decode("utf-8")  # strict: valid UTF-8, whole codepoints to the end
    assert text.endswith("\n") and 0.99 * spec["pool_bytes"] < len(c.pool) <= spec["pool_bytes"]
    finals = tuple(FRAMES[lang].finals)
    assert all(line.endswith(finals) for line in text.split("\n")[:-1])
    cps = np.frombuffer(text.encode("utf-32-le"), "<u4").astype(np.int64)
    assert np.all(in_script(lang, cps[(cps != 32) & (cps != 10)]))
    assert (" " in text) == (lang == "ru")
    per_cp = len(c.pool) / len(text)
    lo, hi = BYTES_PER_CODEPOINT[lang]
    assert lo <= per_cp <= hi
    lens = unit_lengths(cps)
    over_8, over_16 = float(np.mean(lens > control.CONTROL_LONGEST_MATCH)), float(np.mean(lens > 16))
    assert over_8 > 0 and (over_16 > 0 or lang != "ja")
    ascii_words = float(np.mean(((cps >= ord("a")) & (cps <= ord("z"))) | ((cps >= ord("0")) & (cps <= ord("9")))))
    assert (ascii_words > 0) == (lang != "ru")
    assert len(c.vocab_lines) == 28996 == len(set(c.vocab_lines))
    print(f"{lang}: {per_cp:.4f} bytes a codepoint, {ascii_words:.2%} of codepoints Latin or digits, "
          f"{over_8:.4%} and {over_16:.4%} of {lens.shape[0]} units over 8 and 16 codepoints "
          f"(longest {lens.max()}), built in {build_s:.2f} s of CPU")


def codepoints(text: bytes) -> np.ndarray:
    return np.frombuffer(text.decode("utf-8").encode("utf-32-le"), "<u4").astype(np.int64)


def ideograph_ranks(c: Corpus) -> np.ndarray:
    """The rank in the language's table of each ideograph of the pool; every
    one has to be in the table."""
    cps = codepoints(c.pool)
    ideo = cps[(cps >= IDEOGRAPHS[0]) & (cps <= IDEOGRAPHS[1])]
    table = c.language.ideographs
    order = np.argsort(table)
    rank = order[np.minimum(np.searchsorted(table[order], ideo), table.shape[0] - 1)]
    assert ideo.shape[0] > 0 and np.all(table[rank] == ideo)
    return rank


@pytest.mark.parametrize("lang,types", [("zh", 8105), ("ja", 6355)])
def test_the_ideographs_are_the_published_inventory(lang, types):
    """zh: the 8,105 characters of the 通用规范汉字表; ja: the 6,355 kanji
    of JIS X 0208."""
    c = Corpus({**mix_corpus(lang), **SMALL}, 2**33 + 9, 28996)
    assert c.language.ideographs.shape[0] == types == np.unique(c.language.ideographs).shape[0]
    ideograph_ranks(c)


@pytest.mark.parametrize("seed", [2**33 + 9, 2**31 + 77])
def test_the_zh_ideographs_follow_the_published_coverage(seed):
    """Of the running ideographs, the first 2,500 ranks hold 97.97% and the
    first 3,500 hold 99.48% (现代汉语常用字表), within 0.3 and 0.2 points."""
    rank = ideograph_ranks(Corpus({**mix_corpus("zh"), **SMALL}, seed, 28996))
    top_2500, top_3500 = 100 * np.mean(rank < 2500), 100 * np.mean(rank < 3500)
    print(f"zh: {rank.shape[0]} ideographs, {top_2500:.4f}% in the first 2,500 ranks, {top_3500:.4f}% in 3,500")
    assert abs(top_2500 - 97.97) <= 0.3 and abs(top_3500 - 99.48) <= 0.2


@pytest.mark.parametrize("seed", [2**33 + 9, 2**31 + 77])
def test_the_ru_letters_follow_the_published_table(seed):
    """Each letter's share of the running letters is CYRILLIC_FREQ's within
    1 point."""
    cps = codepoints(Corpus({**mix_corpus("ru"), **SMALL}, seed, 28996).pool)
    letters = cps[np.isin(cps, CYRILLIC)]
    share = 100 * (CYRILLIC[:, None] == letters[None, :]).mean(axis=1)
    gap = np.abs(share - 100 * CYRILLIC_FREQ / CYRILLIC_FREQ.sum())
    print(f"ru: {letters.shape[0]} letters, the widest gap {gap.max():.4f} points")
    assert gap.max() <= 1.0


@pytest.mark.parametrize("lang", ["ru", "zh", "ja"])
def test_the_control_fails_on_a_language(lang):
    """The control (the reference's longest match capped under the vocab's
    longest piece) gives other ids than the reference on each mix's text."""
    c = Corpus({**mix_corpus(lang), **SMALL}, 2**31 + 77, 28996)
    doc = c.pool[:100_000]
    doc = doc[: doc.rindex(b"\n") + 1]
    want = Reference(c.vocab_lines).encode(doc)[0]
    got = control.Control(c.vocab_lines, []).encode_bytes(doc)
    n = min(want.shape[0], got.shape[0])
    wrong = int(np.sum(want[:n] != got[:n])) + abs(want.shape[0] - got.shape[0])
    print(f"{lang}: the control gets {wrong} of {want.shape[0]} ids wrong")
    assert wrong > 0


def test_an_unknown_language_is_refused():
    with pytest.raises(ValueError, match="xx"):
        Corpus({**SPEC, "lang": "xx"}, 1, 3000)
    with pytest.raises(ValueError, match="xx"):
        Corpus(SPEC, 1, 3000, {"en": 0.5, "xx": 0.5})


SCRIPT_OF = {"en": lambda c: "a" <= c <= "z", "ru": lambda c: "а" <= c <= "я" or c == "ё",
             "zh": lambda c: IDEOGRAPHS[0] <= ord(c) <= IDEOGRAPHS[1],
             "ja": lambda c: "ぁ" <= c <= "ヺ"}


@pytest.mark.parametrize("lang", ["en", "ru", "zh", "ja"])
def test_a_multilingual_vocab(lang):
    spec = {**mix_corpus(lang), **SMALL}
    c = Corpus(spec, 13, 12_000, MULTI)
    assert len(c.vocab_lines) == 12_000 == len(set(c.vocab_lines))
    chars = set("".join(c.vocab_lines))
    assert all(any(map(SCRIPT_OF[s], chars)) for s in MULTI)
    # the vocab sample leaves the documents as they are
    assert c.pool == Corpus(spec, 13, 12_000).pool
    assert c.vocab_lines == Corpus(spec, 13, 12_000, MULTI).vocab_lines


def loop_vocab_units(sample: bytes, vocab_size: int) -> list[str]:
    """make_vocab_units as a loop over the text's units and a Counter."""
    text = sample.decode("utf-8")
    units, cur = Counter(), []
    for ch in text + " ":
        if is_spacing(ch):
            if cur:
                units["".join(cur)[:UNIT_CAP]] += 1
            cur = []
        else:
            cur.append(ch)
    pieces: dict[str, list] = {}

    def add(piece, weight, seq):
        got = pieces.setdefault(piece, [0.0, seq])
        got[0] += weight

    for r, (u, c) in enumerate(units.items()):
        for l in range(1, min(len(u), LONGEST_PREFIX) + 1):
            add(u[:l], c, (r, l - 1))
        for st in range(1, len(u)):
            for l in range(1, min(len(u) - st, LONGEST_CONT) + 1):
                add("##" + u[st : st + l], c / 4, (r, LONGEST_PREFIX + (st - 1) * LONGEST_CONT + l - 1))
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [f"[unused{i}]" for i in range(100)]
    seen = set(vocab)
    punct = [",", ".", "!", "?", ";", "-", ":", "'", '"', "(", ")", "/"]
    chars = sorted(set(text) - set(" \n"))
    for cand in punct + chars + ["##" + ch for ch in chars if ch not in punct]:
        if cand not in seen:
            vocab.append(cand)
            seen.add(cand)
    prefix_hist = [0.02, 0.04, 0.08, 0.12, 0.14, 0.14, 0.13, 0.11, 0.08, 0.06, 0.04, 0.02, 0.01, 0.01]
    cont_hist = [0.15, 0.25, 0.20, 0.15, 0.10, 0.07, 0.04, 0.02, 0.01, 0.005, 0.005, 0.0, 0.0, 0.0]
    remaining = vocab_size - len(vocab)
    n_cont = int(remaining * 0.22)
    quota = {}
    for l in range(1, 15):
        quota[(False, l)] = int((remaining - n_cont) * prefix_hist[l - 1])
        quota[(True, l)] = int(n_cont * cont_hist[l - 1])
    ranked = sorted((p for p in pieces if p not in seen), key=lambda p: (-pieces[p][0], pieces[p][1]))
    spill = []
    for piece in ranked:
        if len(vocab) >= vocab_size:
            break
        is_cont = piece.startswith("##")
        l = min(len(piece) - (2 if is_cont else 0), 14)
        if quota[(is_cont, l)] > 0:
            quota[(is_cont, l)] -= 1
            vocab.append(piece)
        else:
            spill.append(piece)
    vocab += spill[: max(vocab_size - len(vocab), 0)]
    lacking = [chr(c) for c in range(IDEOGRAPHS[0], IDEOGRAPHS[1] + 1) if chr(c) not in seen]
    return (vocab + lacking + ["##" + c for c in lacking])[:vocab_size]


def sample_of(lang: str, seed: int, nbytes: int) -> bytes:
    return language(lang, 2000, 1.0, rng_for(seed, 0)).text(rng_for(seed, 2), nbytes)[0]


@pytest.mark.parametrize("vocab_size", [6000, 28996])
@pytest.mark.parametrize("langs", [["ru"], ["zh"], ["ja"], ["en", "ru", "zh", "ja"]], ids="-".join)
def test_the_units_vocab_equals_the_loop(langs, vocab_size):
    sample = b"".join(sample_of(lang, 21 + i, 60_000 // len(langs)) for i, lang in enumerate(langs))
    got = make_vocab_units(sample, vocab_size)
    assert got == loop_vocab_units(sample, vocab_size)
    assert len(got) == vocab_size == len(set(got))

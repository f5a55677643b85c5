"""The traffic generator: deterministic from its seed, documents cut at
spaces, every seed the same sizes, and the vectorised vocab builder equal
to the loop it copies."""

from collections import Counter

import numpy as np
import pytest

from wpbench.corpus import Corpus, WordTypes, make_text, make_vocab_bert, rng_for
from wpbench.traffic import N_DOCS, Documents, size_set

SPEC = {"word_types": 2000, "zipf_exponent": 1.0, "pool_bytes": 200_000, "vocab_sample_bytes": 60_000}
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
    text, counts = make_text(rng_for(7, 1), words, 50_000, 1.0)
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
    text, counts = make_text(rng_for(seed, 2), words, size, 1.0)
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

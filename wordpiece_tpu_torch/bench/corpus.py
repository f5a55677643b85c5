"""Deterministic synthetic corpora + WordPiece-style vocab for benchmarks.

The reference benchmarks on linguatools Wikipedia dumps with the
bert-base-cased vocab (tests/speed_test.py:126-151); this environment has
no network, so we synthesize a statistically similar workload: Zipfian
word frequencies, bert-like word-length distribution, punctuation and
multilingual segments, and a 30k-entry WordPiece vocab built greedily
from corpus substrings (prefix + ## continuation pieces).
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import Counter

import numpy as np

CACHE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", ".bench_cache")


def _cache_path(name: str) -> str:
    os.makedirs(CACHE_DIR, exist_ok=True)
    return os.path.join(CACHE_DIR, name)


def _write_cache(path: str, data: bytes) -> None:
    """Write a cache entry whole or not at all (a temporary file, then
    os.replace), so a concurrent reader never sees part of it."""
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def make_word_list(rng: np.random.Generator, n_words: int = 20000) -> list[str]:
    letters = np.array(list("etaoinshrdlcumwfgypbvkjxqz"))
    # Roughly English letter frequencies.
    freq = np.array([12.7, 9.1, 8.2, 7.5, 7.0, 6.7, 6.3, 6.1, 6.0, 4.3, 4.0, 2.8, 2.8, 2.4,
                     2.4, 2.2, 2.0, 2.0, 1.9, 1.5, 1.0, 0.8, 0.2, 0.15, 0.1, 0.07])
    p = freq / freq.sum()
    lens = np.clip(rng.poisson(4.7, size=n_words) + 1, 1, 16)
    return ["".join(rng.choice(letters, size=l, p=p)) for l in lens]


def make_corpus(size_bytes: int, seed: int = 17, lang: str = "en") -> bytes:
    """Deterministic pseudo-natural corpus of ~size_bytes."""
    key = f"corpus_{lang}_{size_bytes}_{seed}.txt"
    path = _cache_path(key)
    if os.path.exists(path) and os.path.getsize(path) == size_bytes:
        with open(path, "rb") as f:
            return f.read()

    rng = np.random.default_rng(seed)
    words = make_word_list(rng)
    n = len(words)
    # Zipf ranks.
    ranks = np.arange(1, n + 1)
    p = 1.0 / ranks
    p /= p.sum()

    extra: list[str] = []
    if lang == "ru":
        letters = np.array(list("оеаинтсрвлкмдпуяызбгчйхжшюцщэфъё"))
        lens = np.clip(rng.poisson(5.2, 4000) + 1, 1, 14)
        picks = rng.integers(0, letters.shape[0], size=int(lens.sum()))
        joined = "".join(letters[picks])
        offs = np.concatenate([[0], np.cumsum(lens)])
        extra = [joined[offs[i]:offs[i+1]] for i in range(4000)]
    elif lang == "zh":
        cps = rng.integers(0x4E00, 0x9FFF, size=4000)
        extra = [chr(int(c)) for c in cps]
    elif lang == "ja":
        kana = [chr(int(c)) for c in rng.integers(0x3041, 0x30F6, size=2000)]
        kanji = [chr(int(c)) for c in rng.integers(0x4E00, 0x9FFF, size=2000)]
        extra = kana + kanji

    parts: list[str] = []
    total = 0
    punct = [",", ".", "!", "?", ";", "-", ":"]
    word_arr = np.array(words)
    extra_arr = np.array(extra) if extra else None
    # Draw in large vectorized batches; assemble sentences from slices.
    while total < size_bytes + 1024:
        ks = rng.integers(8, 18, size=512)
        n_draw = int(ks.sum())
        draw = word_arr[rng.choice(len(words), size=n_draw, p=p)]
        use_extra = extra_arr is not None and lang != "en"
        if use_extra:
            edraw = extra_arr[rng.integers(0, len(extra_arr), size=n_draw)]
            which = rng.random(size=512) < 0.5
        off = 0
        for si in range(512):
            k = int(ks[si])
            if use_extra and which[si]:
                sent = edraw[off : off + k].tolist()
            else:
                sent = draw[off : off + k].tolist()
            off += k
            if rng.random() < 0.6:
                sent.insert(int(rng.integers(1, k)), punct[int(rng.integers(0, len(punct)))])
            line = " ".join(sent) + punct[int(rng.integers(0, 3))] + "\n"
            parts.append(line)
            total += len(line.encode("utf-8"))
            if total >= size_bytes + 1024:
                break
    data = "".join(parts).encode("utf-8")[:size_bytes]
    # Don't cut mid-codepoint: trim trailing continuation bytes.
    while data and (data[-1] & 0xC0) == 0x80:
        data = data[:-1]
    _write_cache(path, data)
    return data


def make_vocab_bert(corpus: bytes, vocab_size: int = 28996, seed: int = 17) -> list[str]:
    """bert-base-cased-SHAPED WordPiece vocab from corpus substrings.

    The reference benches with the real bert-base-cased vocab.txt
    (reference README.md:47); this zero-egress environment cannot fetch
    it, so this generator matches its published shape instead: 28,996
    entries, 5 specials + 100 [unusedN] slots, every single character of
    the corpus in bare and ## form, a ~22% ##-continuation fraction, and
    per-length quotas approximating bert's token-length histogram
    (prefix tokens peaked at 4-8 chars, ## tokens skewed short).  Piece
    CONTENT is still corpus-driven (greedy by frequency, like
    make_vocab) so probe hit rates are realistic.
    """
    # len(corpus) must be part of the key: corpora of different sizes share
    # their first 64 KB (same rng prefix), but the vocab is built from the
    # FULL text — without the length, a 10 MB run would silently reuse a
    # vocab derived from a 1 MB corpus (and vice versa).
    key = (
        f"vocabbert_{vocab_size}_{seed}_{len(corpus)}_"
        f"{hashlib.sha1(corpus[:65536]).hexdigest()[:10]}.txt"
    )
    path = _cache_path(key)
    if os.path.exists(path):
        with open(path, "r", encoding="utf-8") as f:
            return f.read().splitlines()

    text = corpus.decode("utf-8", errors="ignore")
    words = Counter()
    for line in text.splitlines()[:200000]:
        for w in line.replace(",", " ").replace(".", " ").replace("!", " ").replace(
            "?", " "
        ).replace(";", " ").replace(":", " ").replace("-", " ").split():
            words[w] += 1

    pieces: Counter = Counter()
    for w, c in words.items():
        for l in range(1, min(len(w), 18) + 1):
            pieces[w[:l]] += c
        for st in range(1, len(w)):
            for l in range(1, min(len(w) - st, 14) + 1):
                pieces["##" + w[st : st + l]] += c / 4

    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    vocab += [f"[unused{i}]" for i in range(100)]
    seen = set(vocab)
    # Punct + every corpus single char (bare, plus ## form for non-punct
    # chars — bert has no ##-punct), deduplicated as we go: duplicate
    # vocab lines are out-of-contract (the reference's verifyVocab
    # rejects them, tests/tests.cpp:29-33) and engines may legally bind
    # different ids for them.
    punct = [",", ".", "!", "?", ";", "-", ":", "'", '"', "(", ")", "/"]
    chars = sorted({ch for ch in text if not ch.isspace()})
    for cand in punct + chars + ["##" + ch for ch in chars if ch not in punct]:
        if cand not in seen:
            vocab.append(cand)
            seen.add(cand)

    # Approximate bert-base-cased per-length shares (len 1..14+).
    prefix_hist = [0.02, 0.04, 0.08, 0.12, 0.14, 0.14, 0.13, 0.11,
                   0.08, 0.06, 0.04, 0.02, 0.01, 0.01]
    cont_hist = [0.15, 0.25, 0.20, 0.15, 0.10, 0.07, 0.04, 0.02,
                 0.01, 0.005, 0.005, 0.0, 0.0, 0.0]
    remaining = vocab_size - len(vocab)
    n_cont = int(remaining * 0.22)
    n_prefix = remaining - n_cont
    quota: dict[tuple[bool, int], int] = {}
    for l in range(1, 15):
        quota[(False, l)] = int(n_prefix * prefix_hist[l - 1])
        quota[(True, l)] = int(n_cont * cont_hist[l - 1])

    ranked = [p for p, _ in pieces.most_common() if p not in seen]
    spill: list[str] = []
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
    # Quota rounding / exhausted-length slack: fill from global order.
    for piece in spill:
        if len(vocab) >= vocab_size:
            break
        vocab.append(piece)
        seen.add(piece)
    _write_cache(path, "\n".join(vocab).encode("utf-8"))
    return vocab


def make_vocab(corpus: bytes, vocab_size: int = 30000, seed: int = 17) -> list[str]:
    """Greedy frequency-based WordPiece-style vocab from corpus substrings."""
    # len(corpus) in the key for the same reason as make_vocab_bert: size
    # variants share a 64 KB prefix but derive different piece sets.
    key = (
        f"vocab_{vocab_size}_{seed}_{len(corpus)}_"
        f"{hashlib.sha1(corpus[:65536]).hexdigest()[:10]}.txt"
    )
    path = _cache_path(key)
    if os.path.exists(path):
        with open(path, "r", encoding="utf-8") as f:
            return f.read().splitlines()

    text = corpus.decode("utf-8", errors="ignore")
    words = Counter()
    for line in text.splitlines()[:200000]:
        for w in line.replace(",", " ").replace(".", " ").replace("!", " ").replace(
            "?", " "
        ).replace(";", " ").replace(":", " ").replace("-", " ").split():
            words[w] += 1

    pieces: Counter = Counter()
    for w, c in words.items():
        # Prefix pieces and continuation pieces, bert-style.
        for l in range(1, min(len(w), 16) + 1):
            pieces[w[:l]] += c
        for st in range(1, len(w)):
            for l in range(1, min(len(w) - st, 12) + 1):
                pieces["##" + w[st : st + l]] += c / 4

    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    vocab += [",", ".", "!", "?", ";", "-", ":"]
    seen = set(vocab)
    for piece, _c in pieces.most_common():
        if piece not in seen:
            vocab.append(piece)
            seen.add(piece)
        if len(vocab) >= vocab_size:
            break
    _write_cache(path, "\n".join(vocab).encode("utf-8"))
    return vocab

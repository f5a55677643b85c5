"""The port's fast-stream engine (engine.FastEncoder on device="cpu": the
same features, probe and commit the card runs, with the probe's plain
version) against the JAX package's FastEncoder and the oracle.  Mirrors
tests/test_fast_engine.py.  Ids are integers: exact."""

import numpy as np
import pytest
import torch

from wordpiece_tpu import engine as jengine
from wordpiece_tpu.core.vocab import parse_vocab as jax_parse_vocab
from wordpiece_tpu_torch import engine
from wordpiece_tpu_torch.bench.corpus import make_corpus, make_vocab
from wordpiece_tpu_torch.core import unicode as uni
from wordpiece_tpu_torch.core.oracle import encode_oracle
from wordpiece_tpu_torch.core.vocab import parse_vocab
from wordpiece_tpu_torch.engine import FastEncoder
from wordpiece_tpu_torch.ops import match_fast

torch.set_num_threads(1)

UNK = -1


def run_three(text: str, vocab_lines) -> list:
    """Port == JAX FastEncoder == oracle; returns the ids."""
    cps = uni.decode_utf8(text.encode("utf-8")).astype(np.int32)
    want = encode_oracle(cps, parse_vocab(vocab_lines))
    got = FastEncoder(parse_vocab(vocab_lines), device="cpu").encode_codepoints(cps)
    ref = jengine.FastEncoder(jax_parse_vocab(vocab_lines)).encode_codepoints(cps)
    assert got.dtype == np.int32
    assert got.tolist() == ref.tolist() == want, f"text={text[:60]!r} got={got[:40]} want={want[:40]}"
    return got.tolist()


def test_bucket_size_equal_jax():
    ns = [0, 1, 127, 128, 129, 1000, 4096, 4097, (1 << 22) - 1, 1 << 22, (1 << 22) + 1,
          12_000_000, 3 << 22]
    assert [engine.bucket_size(n) for n in ns] == [jengine.bucket_size(n) for n in ns]


@pytest.mark.parametrize(
    "text,vocab,expected",
    [
        ("aaaa", ["aaaa", "aaa", "aa", "a"], [0]),
        ("abcdef", ["bcde", "ac", "def", "bc", "bcdef", "a"], [UNK]),
        ("abcdef", ["bcde", "ac", "def", "bc", "##bcdef", "a"], [5, 4]),
        ("   aaaa  ", ["aa", "##aa"], [0, 1]),
        ("   aaaa  ", ["aa"], [UNK]),
        ("aaaa", ["aa", "##a"], [0, 1, 1]),
        ("self-made", ["self", "made", "-", "##-", "##made"], [0, 2, 1]),
        ("abc a abc abd", ["a", "abd"], [UNK, 0, UNK, 1]),
        ("abcdef", ["a", "##bcdef", "ab", "##c", "##d", "##e", "##f"], [2, 3, 4, 5, 6]),
        ("привет мир", ["при", "##вет", "мир"], [0, 1, 2]),
        (
            "токенизация это круто",
            ["ток", "крут", "это", "##за", "##ени", "##о", "##ция", "ция"],
            [0, 4, 3, 6, 2, 1, 5],
        ),
        ("中文", ["中", "文"], [0, 1]),
        ("中ab", ["中ab", "中", "a", "##b", "ab"], [0]),
        ("-a", ["-a", "-", "a"], [1, 2]),
        ("abcdefghij zz", ["ab", "zz"], [UNK, 1]),
        ("   ", ["a"], []),
        ("x", ["[UNK]", "x"], [1]),
        ("𠀀x 𠀀", ["[UNK]", "𠀀", "##x", "𠀀x"], [3, 1]),
    ],
)
def test_unit_vectors(text, vocab, expected):
    assert run_three(text, vocab) == expected


def test_empty_input():
    enc = FastEncoder(parse_vocab(["a"]), device="cpu")
    out = enc.encode_codepoints(np.zeros(0, dtype=np.int32))
    assert out.dtype == np.int32 and out.shape == (0,)


def random_split_vocab(rng: np.random.Generator, s: str, parts: int) -> list[str]:
    """randomSplit (tests.cpp:111-135): vocab fully covering s."""
    borders = {len(s)}
    while len(borders) < parts:
        borders.add(int(rng.integers(1, len(s))))
    vocab = set()
    start = 0
    for b in sorted(borders):
        piece = s[start:b]
        if start == 0:
            vocab.add(piece)
        vocab.add("##" + piece)
        start = b
    return sorted(vocab)


@pytest.mark.parametrize("positive", [True, False])
def test_random_split_stress(positive):
    rng = np.random.default_rng(17)
    alphabet = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    for text_len in (10, 44, 95):
        for parts in (2, 7):
            s = "".join(rng.choice(alphabet, size=text_len))
            vocab = random_split_vocab(rng, s, parts)
            if not positive and len(vocab) > 1:
                vocab = vocab[1:]
            got = run_three(s, vocab)
            if positive:
                assert UNK not in got


def test_long_space_free_run():
    """A 2,000-codepoint unit: the commit's fixed doubling rounds (11) must
    reach its end."""
    rng = np.random.default_rng(9)
    pieces = ["ab", "c", "abc", "d"]
    run = "".join(pieces[int(i)] for i in rng.integers(0, 4, size=2000))[:2000]
    text = "x " + run + " ab"
    vocab = ["[UNK]", "x", "ab", "c", "abc", "d", "##ab", "##c", "##abc", "##d"]
    got = run_three(text, vocab)
    assert len(got) > 800


def test_corpus_equals_jax_and_oracle():
    """A multilingual corpus slice on a vocab with probe chains longer than
    one slot, at a size past the smallest bucket."""
    data = make_corpus(40_000, lang="zh") + b" " + make_corpus(20_000, lang="ru")
    lines = make_vocab(data, vocab_size=1500)
    enc = FastEncoder(parse_vocab(lines), device="cpu")
    assert enc.index.max_probe >= 2
    cps = uni.decode_utf8(data).astype(np.int32)
    got = enc.encode_codepoints(cps)
    ref = jengine.FastEncoder(jax_parse_vocab(lines)).encode_codepoints(cps)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, encode_oracle(cps, parse_vocab(lines)))


def test_cpu_encode_launches_no_kernel():
    """On the CPU the probe runs its plain version: no kernel launch is
    counted, by this engine or the word engine's wrappers."""
    from wordpiece_tpu_torch.ops import word_kernel_cuda as wk

    before = (match_fast.match_positions.launches, wk.word_match_commit_multi.launches)
    run_three("a b ab", ["[UNK]", "a", "b", "##b"])
    assert (match_fast.match_positions.launches, wk.word_match_commit_multi.launches) == before


# encode_bytes: the bytes decoded as the reference decodes them (invalid
# bytes dropped; the native decoder from 4,096 bytes on), then the same
# path as encode_codepoints.  Held to encode_codepoints, the port's oracle
# and the port's fast and linear engines' encode_bytes.
def _cut(data: bytes, n: int) -> bytes:
    """The first n bytes of an ASCII corpus: n codepoints."""
    assert len(data) >= n and data[:n].isascii()
    return data[:n]


BYTES_CASES = {
    "invalid_utf8": lambda t: b"\xff" + t[:300] + b" \xc3 ab\x80cd \xe2\x82 " + t[300:600] + b"\xed\xa0\x80 x\xf8",
    "cjk": lambda t: t[:200] + " 中文字 東京タワー 中ab ".encode() + t[200:400],
    "u2581": lambda t: t[:200] + " ▁the ▁ ab▁cd ".encode() + t[200:400],
    "longer_than_longest_token": lambda t: t[:100] + b" " + b"abcdefgh" * 9 + b" " + b"e" * 70 + b" " + t[100:300],
    "whole_word_unk": lambda t: t[:100] + " abcЖxyz theЖ Ж ".encode() + t[100:300],
    "empty": lambda t: b"",
    "cp_127": lambda t: _cut(t, 127),
    "cp_128": lambda t: _cut(t, 128),
    "cp_129": lambda t: _cut(t, 129),
    "bytes_4095": lambda t: _cut(t, 4095),
    "bytes_4096": lambda t: _cut(t, 4096),
    "bytes_4097": lambda t: _cut(t, 4097),
    "cjk_across_4096": lambda t: _cut(t, 4094) + "中文".encode(),
    "corpus_20k": lambda t: t,
}


@pytest.fixture(scope="module")
def bytes_engines():
    from wordpiece_tpu_torch import make_encoder
    from wordpiece_tpu_torch.runtime import loader

    if not loader.available():
        pytest.skip("native runtime required by the fast and linear engines")
    text = make_corpus(20_000, seed=23)
    lines = make_vocab(text, vocab_size=800, seed=23)
    vocab = parse_vocab(lines)
    assert vocab.max_len < 70
    engines = {name: make_encoder(vocab, name, device="cpu") for name in ("fast-stream", "fast", "linear")}
    return text, vocab, engines


@pytest.mark.parametrize("case", list(BYTES_CASES))
def test_encode_bytes_equals_codepoints_oracle_and_engines(case, bytes_engines):
    text, vocab, engines = bytes_engines
    data = BYTES_CASES[case](text)
    got = engines["fast-stream"].encode_bytes(data)
    cps = uni.decode_utf8(data)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, engines["fast-stream"].encode_codepoints(cps))
    np.testing.assert_array_equal(got, np.asarray(encode_oracle(cps.astype(np.int32), vocab), dtype=np.int32))
    for name in ("fast", "linear"):
        np.testing.assert_array_equal(got, engines[name].encode_bytes(data), err_msg=name)
    if case == "whole_word_unk":
        assert (got == vocab.unk_token_id).sum() >= 3
    if case == "empty":
        assert got.shape == (0,)

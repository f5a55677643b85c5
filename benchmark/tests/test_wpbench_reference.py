"""The plain reference against the C++ reference's own id streams, and
against the port's native oracle on texts that reach every rule: UNK
rollback, punctuation, CJK, U+2581 and invalid UTF-8.  (Only the tests
import the port; the reference imports nothing of it.)"""

import glob
import os

import numpy as np
import pytest
from conftest import ROOT

from wpbench.reference import Reference, decode

GOLDEN = sorted(glob.glob(os.path.join(ROOT, "tests", "golden", "golden_*.npz")))


@pytest.mark.parametrize("path", GOLDEN, ids=os.path.basename)
def test_reference_equals_the_golden_streams(path):
    from wordpiece_tpu_torch.bench.corpus import make_corpus, make_vocab

    z = np.load(path)
    corpus = make_corpus(int(z["corpus_bytes"]), lang=str(z["lang"]))
    lines = make_vocab(corpus, vocab_size=int(z["vocab_size"]))
    ids, unit_cps, unit_ids = Reference(lines).encode(corpus)
    np.testing.assert_array_equal(ids, z["ids"].astype(np.int32))
    assert 0 < unit_ids <= ids.shape[0] and unit_cps > 0


def test_six_golden_streams():
    assert len(GOLDEN) == 6


def _random_bytes(rng, n):
    pieces = [b"ab", b"abc", b"cab", b" ", b"\n", b",", b"##", b"\xe4\xb8\xad", b"\xe2\x96\x81",
              b"\xd0\xb6", b"\xff", b"\xe2\x82", b"\xed\xa0\x80", b"\xc0\x80", b"\xf4\x90\x80\x80",
              b"zq", b".", b"\xc2\xb7", b"\xe2\x80\x94", b"[UNK]"]
    return b"".join(pieces[i] for i in rng.integers(0, len(pieces), size=n))


def test_decode_equals_the_port_decoder():
    from wordpiece_tpu_torch.core.unicode import decode_utf8

    rng = np.random.default_rng(0)
    for _ in range(300):
        data = _random_bytes(rng, int(rng.integers(0, 60)))
        got = np.array([ord(c) for c in decode(data)], dtype=np.uint32)
        np.testing.assert_array_equal(got, decode_utf8(data, native=False))


VOCABS = [
    ["[UNK]", "a", "b", "ab", "##b", "##c", "c", ",", "中", "##ab", "·", "—"],
    ["[PAD]", "abc", "##a", "##b", "a", "zq", "##zq", "ab", "#", "..", "x", "中a", b"\xffab"],
    ["a", "##a", "b", "##b", "c", "##c", "[UNK]", "ab", "##ab", "cab", "##cab", "z", "##q"],
]


@pytest.mark.parametrize("lines", VOCABS, ids=["unk-heavy", "no-unk-line", "dense"])
def test_reference_equals_the_native_oracle(lines):
    from wordpiece_tpu_torch.core.unicode import decode_utf8
    from wordpiece_tpu_torch.core.vocab import parse_vocab
    from wordpiece_tpu_torch.runtime import loader

    raw = [l.encode() if isinstance(l, str) else l for l in lines]
    vocab = parse_vocab(raw)
    handle = loader.VocabHandle(vocab)
    ref = Reference(lines)
    rng = np.random.default_rng(len(lines))
    for _ in range(200):
        data = _random_bytes(rng, int(rng.integers(0, 80)))
        want = handle.encode(decode_utf8(data, native=False))
        np.testing.assert_array_equal(ref.encode(data)[0], want)


def test_an_empty_word_is_refused():
    with pytest.raises(ValueError):
        Reference(["a", "##"])


def test_the_control_breaks_the_longest_match():
    lines = ["[UNK]", "abcdefghij", "a", "##b", "##c", "##d", "##e", "##f", "##g", "##h", "##i", "##j"]
    data = b"abcdefghij"
    assert Reference(lines).encode(data)[0].tolist() == [1]
    assert Reference(lines, longest_match=8).encode(data)[0].tolist() == [2, 3, 4, 5, 6, 7, 8, 9, 10, 11]


@pytest.mark.parametrize("lines", VOCABS, ids=["unk-heavy", "no-unk-line", "dense"])
def test_a_run_is_its_segments(lines):
    """encode_run, segment by segment and each distinct segment once, gives
    the ids of the loop over the whole run."""
    ref = Reference(lines)
    rng = np.random.default_rng(7 + len(lines))
    kana = [b"\xe3\x81\x82", b"\xe3\x82\xab", b"\xe3\x80\x81", b"\xef\xbc\x8c"]  # あ カ 、 ，
    for _ in range(300):
        data = _random_bytes(rng, int(rng.integers(0, 80)))
        data += b"".join(kana[i] for i in rng.integers(0, 4, size=int(rng.integers(0, 20))))
        for run in decode(data).split():
            assert ref.encode_run(run) == ref.encode_segment(run), run

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


# Pieces: a document of more codepoints than the ladder's cap runs as
# pieces of at most the cap, each cut just before a space-class codepoint.
# Held here with the cap patched small, to the whole text as one program
# (encode_padded on one bucket), the oracle and the JAX engine.
CAP = 4096
SNOWMAN = "☃"  # a codepoint no vocab below holds: a whole-word [UNK]


@pytest.fixture(scope="module")
def piece_setup():
    en = make_corpus(60_000, seed=41)
    sample = en[:20_000] + b" " + b" ".join(make_corpus(12_000, lang=lang, seed=41)
                                            for lang in ("ru", "zh", "ja"))
    lines = make_vocab(sample, vocab_size=1500, seed=41)
    assert SNOWMAN not in "".join(lines)
    vocab = parse_vocab(lines)
    return en, lines, vocab, FastEncoder(vocab, device="cpu"), jengine.FastEncoder(jax_parse_vocab(lines))


@pytest.fixture
def small_cap(monkeypatch):
    monkeypatch.setattr(engine, "LADDER_CAP", CAP)


def whole_text(enc, cps: np.ndarray) -> np.ndarray:
    """The whole text as one program: encode_padded on one bucket."""
    cp_pad = torch.from_numpy(engine.pad_codepoints(cps, enc._statics["max_len"]))
    ids, count = engine.encode_padded(cp_pad, cps.shape[0], enc.table, **enc._statics)
    return ids[: int(count)].numpy()


def fill(en: bytes, m: int, at: int = 0) -> bytes:
    """m ASCII codepoints of the corpus, the last a space."""
    assert en[at : at + m].isascii()
    return en[at : at + m - 1] + b" "


def space_free(m: int) -> bytes:
    rng = np.random.default_rng(m)
    return b"".join([b"ab", b"c", b"the", b"d"][int(i)] for i in rng.integers(0, 4, m))[:m]


PIECE_CASES = {
    "whitespace_run": lambda en: fill(en, 4086) + b" \t \n  \r\n   " * 2 + en[5000:12000],
    "unk_ending_before_cut": lambda en: fill(en, 4091) + f"ab{SNOWMAN}xy".encode() + b" " + en[5000:12000],
    "unk_starting_after_cut": lambda en: fill(en, 4097) + f"ab{SNOWMAN}xy ".encode() + en[5000:12000],
    "truncated_multibyte_before_cut": lambda en: fill(en, 4095) + b"q\xe2\x82 " + fill(en, 4000, 5000)
    + b"\xf0 " + en[9000:13000],
    "newline_only": lambda en: en[:12000].replace(b" ", b"\n"),
    "u2581_only": lambda en: en[:12000].replace(b" ", "▁".encode()),
    "ru": lambda en: make_corpus(24_000, lang="ru", seed=43),
    "zh": lambda en: make_corpus(30_000, lang="zh", seed=43),
    "ja": lambda en: make_corpus(30_000, lang="ja", seed=43),
    "space_free_fallback": lambda en: space_free(10_000) + b" " + en[5000:7000],
    "fallback_after_pieces": lambda en: fill(en, 9000) + space_free(8_000) + b" " + en[10000:12000],
    "n_is_cap": lambda en: en[:CAP],
    "n_is_cap_plus_1": lambda en: en[: CAP + 1],
}


@pytest.mark.parametrize("case", list(PIECE_CASES))
def test_pieces_equal_whole_text_oracle_and_jax(case, piece_setup, small_cap):
    from wordpiece_tpu_torch.utils.profiling import StageStats

    en, _, vocab, enc, jenc = piece_setup
    data = PIECE_CASES[case](en)
    cps = uni.decode_utf8(data).astype(np.int32)
    want = whole_text(enc, cps)
    np.testing.assert_array_equal(want, np.asarray(encode_oracle(cps, vocab), dtype=np.int32))
    np.testing.assert_array_equal(want, jenc.encode_codepoints(cps))
    enc.stats = StageStats()
    try:
        np.testing.assert_array_equal(enc.encode_bytes(data), want)
        by_bytes = enc.stats.report()["counters"]["stream_pieces"]
        np.testing.assert_array_equal(enc.encode_codepoints(cps), want)
    finally:
        enc.stats = None
    counted = engine.utf8_decode.count_codepoints(torch.from_numpy(np.frombuffer(data, np.uint8).copy()),
                                                  prefixes=True)
    pieces = engine.byte_pieces(data, counted, CAP)
    assert by_bytes == len(pieces) == len(engine.codepoint_pieces(cps, CAP))
    if case == "n_is_cap":
        assert len(pieces) == 1 and cps.shape[0] == CAP
    elif case == "space_free_fallback":
        assert len(pieces) == 1  # the whole document, past the cap
    elif case == "fallback_after_pieces":
        assert len(pieces) >= 2 and pieces[-1][2] > CAP
    else:
        assert len(pieces) >= 2 and max(k for _, _, k in pieces) <= CAP
    if case.startswith("unk"):
        assert (want == vocab.unk_token_id).any()


@pytest.mark.parametrize("seed", range(2))
def test_random_cut_stress(seed, piece_setup, monkeypatch):
    """Slices of a mixed-language corpus at seeded offsets (multibyte
    sequences cut at their ends), under seeded caps."""
    en, _, vocab, enc, _ = piece_setup
    rng = np.random.default_rng(seed)
    corpus = en[:20_000] + b" ".join(make_corpus(20_000, lang=lang, seed=seed) for lang in ("ru", "zh", "ja"))
    cut = 0
    for _ in range(5):
        lo = int(rng.integers(0, len(corpus) - 9000))
        data = corpus[lo : lo + int(rng.integers(2000, 9000))]
        cap = int(np.exp(rng.uniform(np.log(64), np.log(4096))))
        monkeypatch.setattr(engine, "LADDER_CAP", cap)
        cps = uni.decode_utf8(data).astype(np.int32)
        want = whole_text(enc, cps)
        np.testing.assert_array_equal(want, np.asarray(encode_oracle(cps, vocab), dtype=np.int32))
        np.testing.assert_array_equal(enc.encode_bytes(data), want, err_msg=f"cap {cap}")
        np.testing.assert_array_equal(enc.encode_codepoints(cps), want, err_msg=f"cap {cap}")
        cut += len(engine.codepoint_pieces(cps, cap)) > 1
    assert cut >= 3


def is_space_start(data: bytes, at: int) -> bool:
    return data[at] in b"\t\n\x0b\x0c\r " or data[at : at + 3] == "▁".encode()


@pytest.mark.parametrize("cap", [1000, CAP])
@pytest.mark.parametrize("lang", ["en", "ru", "zh", "ja"])
def test_the_piece_rule_bounds(lang, cap):
    """Every piece at most cap codepoints, at most ceil(n / cap) + 1 pieces,
    each ending just before a space-class codepoint, and together the
    document; the codepoint rule alike."""
    data = make_corpus(40_000, lang=lang, seed=47)
    counted = engine.utf8_decode.count_codepoints(torch.from_numpy(np.frombuffer(data, np.uint8).copy()),
                                                  prefixes=True)
    n = counted.n
    pieces = engine.byte_pieces(data, counted, cap)
    assert 1 < len(pieces) <= -(-n // cap) + 1
    assert [lo for lo, _, _ in pieces[1:]] == [hi for _, hi, _ in pieces[:-1]]
    assert pieces[0][0] == 0 and pieces[-1][1] == len(data)
    assert [k for _, _, k in pieces] == [len(uni.decode_utf8(data[lo:hi])) for lo, hi, _ in pieces]
    assert max(k for _, _, k in pieces) <= cap
    assert all(is_space_start(data, hi) for _, hi, _ in pieces[:-1])
    cps = uni.decode_utf8(data).astype(np.int32)
    by_cp = engine.codepoint_pieces(cps, cap)
    assert 1 < len(by_cp) <= -(-n // cap) + 1 and max(hi - lo for lo, hi in by_cp) <= cap
    assert [lo for lo, _ in by_cp[1:]] == [hi for _, hi in by_cp[:-1]] and by_cp[-1][1] == n
    assert all(cps[hi] in (9, 10, 11, 12, 13, 32, 0x2581) for _, hi in by_cp[:-1])


def test_piece_counters_and_stages(piece_setup, small_cap):
    """stream_pieces, stream_positions the pieces' buckets and
    stream_table_rows one table a probe launch; the later pieces' bytes
    copied and counted in stream_h2d."""
    from wordpiece_tpu_torch.utils.profiling import StageStats

    en, _, _, enc, _ = piece_setup
    data = en[:10_000]
    counted = engine.utf8_decode.count_codepoints(torch.from_numpy(np.frombuffer(data, np.uint8).copy()),
                                                  prefixes=True)
    pieces = engine.byte_pieces(data, counted, CAP)
    assert len(pieces) == 3
    enc.stats = StageStats()
    try:
        enc.encode_bytes(data)
        rep = enc.stats.report()
    finally:
        enc.stats = None
    assert rep["counters"] == {"stream_pieces": 3,
                               "stream_positions": sum(engine.bucket_size(k) for _, _, k in pieces),
                               "stream_table_rows": 3 * enc.table.slots.shape[0],
                               "stream_card_decoded_bytes": 0}
    assert rep["counters"]["stream_positions"] == 4096 + 4096 + 2048
    assert rep["encode"]["calls"] == rep["host_pad"]["calls"] == 1
    assert rep["stream_h2d"]["calls"] == rep["device_dispatch"]["calls"] == rep["device_fetch"]["calls"] == 3


@pytest.mark.parametrize("lang", ["en", "ru"])
def test_a_document_at_the_cap_runs_one_piece(lang, piece_setup, small_cap, monkeypatch):
    """n = cap: one count (its prefixes read with it where the bytes pass
    the cap), one write, one features, probe and commit call, one id
    count: the launches and reads of a call without pieces."""
    from wordpiece_tpu_torch.ops import commit as commit_ops
    from wordpiece_tpu_torch.ops import text_features, utf8_decode

    _, _, _, enc, _ = piece_setup
    cps = uni.decode_utf8(make_corpus(20_000, lang=lang, seed=53))[:CAP]
    data = uni.encode_utf8(cps)
    want = whole_text(enc, cps.astype(np.int32))
    calls = {}

    def spy(module, name):
        fn = getattr(module, name)

        def counted(*a, **k):
            calls[name] = calls.get(name, []) + [k]
            return fn(*a, **k)

        monkeypatch.setattr(module, name, counted)

    for module, name in ((utf8_decode, "count_codepoints"), (utf8_decode, "write_codepoints"),
                         (text_features, "compute_features"), (match_fast, "match_positions"),
                         (commit_ops, "commit_with_positions"), (utf8_decode, "head")):
        spy(module, name)
    np.testing.assert_array_equal(enc.encode_bytes(data), want)
    assert {k: len(v) for k, v in calls.items()} == {
        "count_codepoints": 1, "write_codepoints": 1, "compute_features": 1, "match_positions": 1,
        "commit_with_positions": 1}
    assert calls["count_codepoints"][0] == {"prefixes": len(data) > CAP}


def test_later_pieces_take_the_cuts_count(piece_setup, small_cap, monkeypatch):
    """The first count brings the tiles' prefixes; each later piece's count
    is given the cut's (and on a card read with the id count of the piece
    before); a cut whose count is wrong raises before its piece runs."""
    from wordpiece_tpu_torch.ops import utf8_decode

    en, _, _, enc, _ = piece_setup
    data = en[:10_000]
    want = enc.encode_bytes(data)
    calls = []
    count = utf8_decode.count_codepoints

    def spy(*a, **k):
        calls.append(k)
        return count(*a, **k)

    monkeypatch.setattr(utf8_decode, "count_codepoints", spy)
    np.testing.assert_array_equal(enc.encode_bytes(data), want)
    counted = count(torch.from_numpy(np.frombuffer(data, np.uint8).copy()), prefixes=True)
    pieces = engine.byte_pieces(data, counted, CAP)
    assert calls == [{"prefixes": True}] + [{"expect": k} for _, _, k in pieces[1:]]
    cut = engine.byte_pieces
    monkeypatch.setattr(engine, "byte_pieces",
                        lambda *a: [(lo, hi, k + (i == 1)) for i, (lo, hi, k) in enumerate(cut(*a))])
    with pytest.raises(RuntimeError):
        enc.encode_bytes(data)

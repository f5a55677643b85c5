"""The port's LinearEncoder on device="cpu" — the same batch program, compact
fetch, overflow copy and streaming pipeline the card runs — against the
JAX package's LinearEncoder and _linear_batch_* programs, the native
oracle and the reference goldens.  Mirrors tests/test_linear_engine.py.
Ids are integers: exact."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wordpiece_tpu import engine_linear as jel
from wordpiece_tpu.core.vocab import parse_vocab as jax_parse_vocab
from wordpiece_tpu_torch.bench.corpus import make_corpus, make_vocab
from wordpiece_tpu_torch.core import unicode as uni
from wordpiece_tpu_torch.core.oracle import encode_oracle
from wordpiece_tpu_torch.core.vocab import parse_vocab
from wordpiece_tpu_torch.engine_linear import (
    LinearEncoder, _bucket, _linear_batch_compact, _linear_batch_core, build_merge_tables,
    load_merge_tables, vocab_tail,
)
from wordpiece_tpu_torch.engine_word import WordEncoder
from wordpiece_tpu_torch.runtime import loader

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
UNK = -1
MERGE_KEYS = ("lut", "bits", "per", "nk", "nv_pad", "tok_keys", "tok_len", "tok_id", "tok_kind")


def enc_cpu(vocab):
    return LinearEncoder(vocab, device="cpu")


def oracle_ids(vocab, data: bytes) -> np.ndarray:
    return loader.VocabHandle(vocab).encode(uni.decode_utf8(data))


def run_linear(text: str, vocab_lines):
    vocab = parse_vocab(vocab_lines)
    cps = uni.decode_utf8(text.encode()).astype(np.int32)
    want = encode_oracle(cps, vocab)
    got = enc_cpu(vocab).encode_codepoints(cps).tolist()
    assert got == want, f"text={text!r} got={got[:40]} want={want[:40]}"
    assert enc_cpu(vocab).encode_bytes(text.encode()).tolist() == want
    return got


def doubling_case():
    """A vocabulary whose packed keys would need nk > 24 sort passes: 1,100
    distinct symbols (11 bits, 2 per key) in tokens of 50 codepoints."""
    rng = np.random.default_rng(11)
    syms = 0x100 + rng.permutation(1100)
    longs = ["".join(chr(c) for c in syms[i : i + 50]) for i in range(0, 1100, 50)]
    singles = sorted({chr(c) for c in syms[:40]})
    lines = ["[UNK]"] + longs + singles + ["##" + c for c in singles]
    words = longs[:6] + [longs[7][:20] + longs[8][:3], "".join(singles[:9])]
    text = " ".join(words[int(i)] for i in rng.integers(0, len(words), size=30))
    return lines, text


def vocab_cases():
    data = make_corpus(100_000, lang="en")
    lines, _ = doubling_case()
    return {
        "en_2000": make_vocab(data, vocab_size=2000),
        "multilingual": ["[UNK]", "при", "##вет", "мир", "中", "文", "a", "##b", "-", "ab",
                         "[CLS]", "!!", "𠀀x"],
        "no_eligible": ["[UNK]", "[CLS]", "!!"],
        "doubling": lines,
    }


@pytest.mark.parametrize("name", ["en_2000", "multilingual", "no_eligible", "doubling"])
def test_merge_tables_equal_jax(name):
    """Built by the port (no per-token loop), built by the JAX package, and
    the JAX tables carried over by load_merge_tables: element for element."""
    lines = vocab_cases()[name]
    vocab = parse_vocab(lines)
    jenc = jel.LinearEncoder(jax_parse_vocab(lines))
    mine = build_merge_tables(vocab, max(vocab.max_len, 1))
    tail, starts = vocab_tail(vocab)
    np.testing.assert_array_equal(tail, jenc._vocab_tail)
    np.testing.assert_array_equal(starts, jenc._tok_starts)
    if name == "doubling":
        assert mine is None and jenc._merge is None
        assert load_merge_tables(jenc._merge, "cpu") is None
        return
    theirs = {k: np.asarray(v) for k, v in jenc._merge.items()}
    for k in MERGE_KEYS:
        np.testing.assert_array_equal(np.asarray(mine[k]), theirs[k], err_msg=k)
        assert np.asarray(mine[k]).dtype == theirs[k].dtype, k
    loaded = load_merge_tables(theirs, "cpu")
    own = LinearEncoder(vocab, device="cpu")._merge
    for k in MERGE_KEYS:
        a, b = getattr(loaded, k), getattr(own, k)
        if isinstance(a, torch.Tensor):
            assert a.dtype == torch.int32 and torch.equal(a, b), k
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


def batch_inputs():
    """One batch of en text on an en vocab: the dense and raw codepoints at
    their bucket length, narrowed to 16 bits as the engine ships them."""
    data = make_corpus(60_000, lang="en")
    lines = make_vocab(data, vocab_size=600)
    cps = uni.decode_utf8(data[:3000]).astype(np.int32)
    vocab = parse_vocab(lines)
    m = build_merge_tables(vocab, vocab.max_len)
    np_ = _bucket(cps.shape[0])
    x = np.full(np_, (1 << m["bits"]) - 1, dtype=np.uint16)
    x[: cps.shape[0]] = m["lut"][cps]
    c = np.full(np_, 32, dtype=np.uint16)
    c[: cps.shape[0]] = cps
    return lines, vocab, m, x, c, cps.shape[0]


def test_linear_batch_core_and_compact_equal_jax():
    lines, vocab, m, x, c, n = batch_inputs()
    statics = dict(bits=m["bits"], per=m["per"], nk=m["nk"], max_len=vocab.max_len,
                   unk_id=vocab.unk_token_id)
    tabs = [m["tok_keys"], m["tok_len"], m["tok_id"], m["tok_kind"]]
    t16 = [torch.from_numpy(a.view(np.int16)) for a in (x, c)]
    ids, positions, count = _linear_batch_core(
        *t16, n, *[torch.from_numpy(a) for a in tabs], **statics
    )
    jargs = [jnp.asarray(x), jnp.asarray(c), jnp.int32(n)] + [jnp.asarray(a) for a in tabs]
    want = [np.asarray(o) for o in jel._linear_batch_device(*jargs, **statics)]
    assert int(count) == int(want[2]) > 0
    np.testing.assert_array_equal(ids.numpy(), want[0])
    np.testing.assert_array_equal(positions.numpy(), want[1])
    count = int(count)
    for cap in (count // 2, count + 64):
        fused, full_ids, full_pos = _linear_batch_compact(
            *t16, n, *[torch.from_numpy(a) for a in tabs], **statics, cap=cap
        )
        np.testing.assert_array_equal(
            fused.numpy(), np.asarray(jel._linear_batch_compact(*jargs, **statics, cap=cap))
        )
        assert torch.equal(full_ids, ids) and torch.equal(full_pos, positions)
    cps = uni.decode_utf8(make_corpus(60_000, lang="en")[:3000]).astype(np.int32)
    assert ids.numpy()[:count].tolist() == encode_oracle(cps, vocab)


@pytest.mark.parametrize(
    "text,vocab,expected",
    [
        ("aaaa", ["aaaa", "aaa", "aa", "a"], [0]),
        ("abcdef", ["bcde", "ac", "def", "bc", "bcdef", "a"], [UNK]),
        ("abcdef", ["bcde", "ac", "def", "bc", "##bcdef", "a"], [5, 4]),
        ("   aaaa  ", ["aa", "##aa"], [0, 1]),
        ("aaaa", ["aa", "##a"], [0, 1, 1]),
        ("self-made", ["self", "made", "-", "##-", "##made"], [0, 2, 1]),
        ("abc a abc abd", ["a", "abd"], [UNK, 0, UNK, 1]),
        ("abcdef", ["a", "##bcdef", "ab", "##c", "##d", "##e", "##f"], [2, 3, 4, 5, 6]),
        ("привет мир", ["при", "##вет", "мир"], [0, 1, 2]),
        ("中ab", ["中ab", "中", "a", "##b", "ab"], [0]),
        ("-a", ["-a", "-", "a"], [1, 2]),
        ("abcdefghij zz", ["ab", "zz"], [UNK, 1]),
    ],
)
def test_linear_unit_vectors(text, vocab, expected):
    assert run_linear(text, vocab) == expected


def test_linear_random_split_stress():
    rng = np.random.default_rng(17)
    alphabet = np.array(list("abcdef"))
    for text_len in (10, 40, 90):
        for parts in (2, 5, 17):
            for positive in (True, False):
                s = "".join(rng.choice(alphabet, size=text_len))
                borders = {text_len}
                while len(borders) < min(parts, text_len):
                    borders.add(int(rng.integers(1, text_len)))
                vocab = set()
                start = 0
                for b in sorted(borders):
                    if start == 0:
                        vocab.add(s[start:b])
                    vocab.add("##" + s[start:b])
                    start = b
                vocab = sorted(vocab)
                if not positive and len(vocab) > 1:
                    vocab = vocab[1:]
                run_linear(s, vocab)


def test_linear_matches_fast_engine_and_jax_linear():
    rng = np.random.default_rng(3)
    words = ["".join(rng.choice(list("abcde"), size=int(rng.integers(1, 9)))) for _ in range(40)]
    text = " ".join(rng.choice(words) for _ in range(150))
    vocab_lines = sorted(
        {w[:3] for w in words} | {"##" + w[3:] for w in words if len(w) > 3} | set("abcde")
    )
    vocab = parse_vocab(vocab_lines)
    cps = uni.decode_utf8(text.encode()).astype(np.int32)
    linear = enc_cpu(vocab).encode_codepoints(cps)
    fast = WordEncoder(vocab, device="cpu").encode_bytes(text.encode())
    jax_linear = jel.LinearEncoder(jax_parse_vocab(vocab_lines)).encode_codepoints(cps)
    assert linear.tolist() == fast.tolist() == jax_linear.tolist()


def test_linear_encode_bytes_deduped_matches_codepoint_path():
    data = make_corpus(300_000)
    vocab = parse_vocab(make_vocab(data, vocab_size=3000))
    enc = enc_cpu(vocab)
    got = enc.encode_bytes(data)
    assert enc.device_batches > 0
    want = enc.encode_codepoints(np.asarray(uni.decode_utf8(data)))
    assert np.array_equal(got, want)
    assert np.array_equal(got, oracle_ids(vocab, data))


def test_linear_encode_bytes_multibatch_units():
    """Unit batching boundaries (MAX_TEXT_BATCH) must not change output."""
    rng = np.random.default_rng(3)
    words = ["".join(rng.choice(list("abcde"), size=int(rng.integers(1, 11)))) for _ in range(300)]
    text = " ".join(rng.choice(words) for _ in range(2000)) + " 中文 mix-ed"
    vocab = parse_vocab(sorted({w[:2] for w in words} | {"##" + c for c in "abcde"}
                               | set("abcde") | {"中", "文", "mix", "##ed", "-"}))
    enc = enc_cpu(vocab)
    enc.MAX_TEXT_BATCH = 256  # force many unit batches
    got = enc.encode_bytes(text.encode())
    assert enc.device_batches > 5
    want = enc_cpu(vocab).encode_codepoints(np.asarray(uni.decode_utf8(text.encode())))
    assert np.array_equal(got, want)
    enc.MAX_TEXT_BATCH = 512  # the codepoint path's space-split batches
    assert np.array_equal(enc.encode_codepoints(np.asarray(uni.decode_utf8(text.encode()))), want)


def test_linear_compact_overflow_refetch():
    """A compact-output capacity overflow (count > cap) must copy the full
    ids back with identical ids, count it in full_fetches, and ratchet the
    cap ratio upward so later batches avoid it."""
    data = make_corpus(120_000)
    vocab = parse_vocab(make_vocab(data, vocab_size=2000))
    enc = enc_cpu(vocab)
    enc._cap_ratio = 0.0001  # force the cap far below the real id count
    got = enc.encode_bytes(data)
    assert enc._cap_ratio > 0.01, "observed density must adapt the ratio"
    assert np.array_equal(got, oracle_ids(vocab, data))
    # A char-level vocabulary emits about one id per codepoint, past the
    # smallest cap (8192).
    chars = sorted(set("".join(data.decode("utf-8", errors="ignore").split())))
    char_vocab = parse_vocab(["[UNK]"] + chars + ["##" + c for c in chars])
    enc = enc_cpu(char_vocab)
    enc._cap_ratio = 0.0001
    got = enc.encode_bytes(data)
    assert enc.full_fetches > 0
    assert np.array_equal(got, oracle_ids(char_vocab, data))


def test_linear_streaming_multi_piece_batches():
    """Batches spanning multiple segmentation pieces (LINEAR_SEG_CHUNK)
    must join across pieces with a single separating space and keep
    uid-order attribution — the >=3 MB streaming path, forced small."""
    data = make_corpus(200_000)
    vocab = parse_vocab(make_vocab(data, vocab_size=2000))
    enc = enc_cpu(vocab)
    enc.LINEAR_SEG_CHUNK = 10_000  # ~20 pieces
    enc.LINEAR_BATCH_TARGET = 3_000  # many batches, most spanning pieces
    got = enc.encode_bytes(data)
    assert np.array_equal(got, oracle_ids(vocab, data))


def test_linear_batches_equal_jax_pipeline():
    """The streaming pipeline cuts the same batches as the JAX package's
    (pieces visited once each, oldest first): the JAX encode_bytes runs
    with its device program swapped for the port's batch on the CPU."""
    data = make_corpus(200_000)
    lines = make_vocab(data, vocab_size=2000)
    mine, theirs = enc_cpu(parse_vocab(lines)), jel.LinearEncoder(jax_parse_vocab(lines))
    sizes = {"port": [], "jax": []}
    for enc in (mine, theirs):
        enc.LINEAR_SEG_CHUNK = 10_000
        enc.LINEAR_BATCH_TARGET = 3_000
    dispatch = mine._encode_batch

    def port_batch(cps, as_handle=False):
        sizes["port"].append(int(cps.shape[0]))
        return dispatch(cps, as_handle=as_handle)

    def jax_dispatch(cps):
        sizes["jax"].append(int(cps.shape[0]))
        return dispatch(np.asarray(cps, np.int32), as_handle=True)

    mine._encode_batch = port_batch
    theirs._dispatch_batch = jax_dispatch
    theirs._fetch_batch = mine._fetch_batch
    got = mine.encode_bytes(data)
    assert np.array_equal(theirs.encode_bytes(data), got)
    assert len(sizes["port"]) > 10 and sizes["port"] == sizes["jax"]
    assert np.array_equal(got, oracle_ids(parse_vocab(lines), data))


def test_linear_pipeline_keeps_at_most_window_batches_in_flight():
    data = make_corpus(100_000)
    vocab = parse_vocab(make_vocab(data, vocab_size=2000))
    enc = enc_cpu(vocab)
    enc.LINEAR_SEG_CHUNK = 20_000
    enc.LINEAR_BATCH_TARGET = 2_000
    in_flight, most = [0], [0]
    dispatch, fetch = enc._encode_batch, enc._fetch_batch

    def counted_dispatch(cps, as_handle=False):
        in_flight[0] += 1
        most[0] = max(most[0], in_flight[0])
        return dispatch(cps, as_handle=as_handle)

    def counted_fetch(handle):
        in_flight[0] -= 1
        return fetch(handle)

    enc._encode_batch, enc._fetch_batch = counted_dispatch, counted_fetch
    got = enc.encode_bytes(data)
    assert enc.device_batches > 2 * enc.PIPELINE_WINDOW
    assert most[0] == enc.PIPELINE_WINDOW and in_flight[0] == 0
    assert np.array_equal(got, oracle_ids(vocab, data))


def test_linear_long_within_unit_chain():
    """One unit of 2,000 single-codepoint tokens through the engine (the
    commit's doubling rounds come from the longest unit)."""
    text = "a" * 2000 + " b"
    vocab = parse_vocab(["[UNK]", "a", "##a", "b"])
    got = enc_cpu(vocab).encode_bytes(text.encode())
    assert got.tolist() == [1] + [2] * 1999 + [3]


def test_linear_doubling_fallback_equals_jax():
    lines, text = doubling_case()
    vocab = parse_vocab(lines)
    enc = enc_cpu(vocab)
    assert enc._merge is None
    cps = uni.decode_utf8(text.encode()).astype(np.int32)
    got = enc.encode_codepoints(cps)
    want = encode_oracle(cps, vocab)
    assert got.tolist() == want and sum(i >= 1 and i <= 22 for i in want) > 10
    assert enc.encode_bytes(text.encode()).tolist() == want
    assert enc.device_batches == 2
    jax_got = jel.LinearEncoder(jax_parse_vocab(lines)).encode_codepoints(cps)
    assert jax_got.tolist() == want


def test_linear_max_slot_len_scalar_route():
    """A token longer than MAX_SLOT_LEN routes every unit to the native
    scalar encoder; no device batch runs."""
    long_tok = "ab" * 50
    lines = ["[UNK]", long_tok, "a", "##b", "ab", "c", "##c"]
    text = f"{long_tok} abab c {long_tok}c zz"
    vocab = parse_vocab(lines)
    enc = enc_cpu(vocab)
    assert enc.max_len > enc.MAX_SLOT_LEN
    want = encode_oracle(uni.decode_utf8(text.encode()), vocab)
    assert enc.encode_bytes(text.encode()).tolist() == want
    cps = uni.decode_utf8(text.encode()).astype(np.int32)
    assert enc.encode_codepoints(cps).tolist() == want
    assert enc.device_batches == 0
    assert jel.LinearEncoder(jax_parse_vocab(lines)).encode_bytes(text.encode()).tolist() == want


@pytest.mark.parametrize(
    "name", ["golden_en_v8000.npz", "golden_zh_v8000.npz", "golden_en_v30000.npz",
             "golden_ru_v30000.npz", "golden_ja_v30000.npz", "golden_zh_v30000.npz"],
)
def test_linear_golden(name):
    z = np.load(os.path.join(GOLDEN_DIR, name))
    corpus = make_corpus(int(z["corpus_bytes"]), lang=str(z["lang"]))
    lines = make_vocab(corpus, vocab_size=int(z["vocab_size"]))
    got = enc_cpu(parse_vocab(lines)).encode_bytes(corpus)
    assert got.dtype == np.int32
    assert got.tobytes() == z["ids"].astype(np.int32).tobytes()

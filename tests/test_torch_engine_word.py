"""The port's WordEncoder on device="cpu" — the same dispatch, compact
decode and overflow logic the card runs, with the kernel's plain version —
against the JAX package's WordEncoder, the native oracle and the reference
goldens.  Mirrors tests/test_word_engine.py and the compact-overflow test
of tests/test_space_class_splitting.py.  Ids are integers: exact."""

import os
import time

import numpy as np
import pytest
import torch

from wordpiece_tpu.core.vocab import parse_vocab as jax_parse_vocab
from wordpiece_tpu.engine_word import WordEncoder as JaxWordEncoder
from wordpiece_tpu_torch.bench.corpus import make_corpus, make_vocab
from wordpiece_tpu_torch.core import unicode as uni
from wordpiece_tpu_torch.core.oracle import encode_oracle_str
from wordpiece_tpu_torch.core.vocab import parse_vocab
from wordpiece_tpu_torch.engine_word import WordEncoder
from wordpiece_tpu_torch.ops import word_kernel_cuda as wk
from wordpiece_tpu_torch.runtime import loader
from wordpiece_tpu_torch.utils.profiling import StageStats, trace

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
UNK = -1


def enc_cpu(vocab, **kw):
    return WordEncoder(vocab, device="cpu", **kw)


def run_both(text: str, vocab_lines):
    vocab = parse_vocab(vocab_lines)
    raw = text.encode("utf-8")
    want = encode_oracle_str(raw, vocab)
    got = enc_cpu(vocab).encode_bytes(raw).tolist()
    assert got == want, f"text={text!r} got={got[:40]} want={want[:40]}"
    return got


def oracle_ids(vocab, data):
    return loader.VocabHandle(vocab).encode(uni.decode_utf8(data))


@pytest.mark.parametrize(
    "name", ["golden_en_v8000.npz", "golden_zh_v8000.npz", "golden_en_v30000.npz",
             "golden_ru_v30000.npz", "golden_ja_v30000.npz", "golden_zh_v30000.npz"],
)
def test_equals_jax_word_encoder_and_golden(name):
    z = np.load(os.path.join(GOLDEN_DIR, name))
    corpus = make_corpus(int(z["corpus_bytes"]), lang=str(z["lang"]))
    lines = make_vocab(corpus, vocab_size=int(z["vocab_size"]))
    got = enc_cpu(parse_vocab(lines)).encode_bytes(corpus)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, z["ids"].astype(np.int32))
    if "_v8000" in name:
        want = JaxWordEncoder(jax_parse_vocab(lines)).encode_bytes(corpus)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "text,vocab,expected",
    [
        ("aaaa", ["aaaa", "aaa", "aa", "a"], [0]),
        ("abcdef", ["bcde", "ac", "def", "bc", "##bcdef", "a"], [5, 4]),
        ("   aaaa  ", ["aa", "##aa"], [0, 1]),
        ("aaaa", ["aa", "##a"], [0, 1, 1]),
        ("self-made", ["self", "made", "-", "##-", "##made"], [0, 2, 1]),
        ("abc a abc abd", ["a", "abd"], [UNK, 0, UNK, 1]),
        ("abcdef", ["a", "##bcdef", "ab", "##c", "##d", "##e", "##f"], [2, 3, 4, 5, 6]),
        ("привет мир", ["при", "##вет", "мир"], [0, 1, 2]),
        ("中文", ["中", "文"], [0, 1]),
        ("中ab", ["中ab", "中", "a", "##b", "ab"], [0]),
        ("-a", ["-a", "-", "a"], [1, 2]),
        ("abcdefghij zz", ["ab", "zz"], [UNK, 1]),
        ("the the the", ["the"], [0, 0, 0]),
    ],
)
def test_word_engine_unit_vectors(text, vocab, expected):
    assert run_both(text, vocab) == expected


def test_word_engine_long_unit_overflow():
    run_both("ab" * 200 + " zz", ["ab", "##ab", "zz"])


def test_word_engine_random_stress():
    rng = np.random.default_rng(19)
    alphabet = np.array(list("abcdef"))
    for trial in range(10):
        words = [
            "".join(rng.choice(alphabet, size=int(rng.integers(1, 14)))) for _ in range(30)
        ]
        text = " ".join(rng.choice(words) for _ in range(200))
        vocab = set()
        for w in words[:20]:
            vocab.add(w[:2])
            if len(w) > 2:
                vocab.add("##" + w[2:4])
            for c in "abcdef":
                vocab.add(c)
                if trial % 2:
                    vocab.add("##" + c)
        run_both(text, sorted(vocab))


def test_word_engine_multilingual():
    run_both(
        "привет 中文 mixed▁tokens, punct-uation! 漢字かな\tтаб",
        ["[UNK]", "привет", "中", "文", "mixed", "tokens", "punct", "##uation",
         "-", ",", "!", "漢", "字", "かな", "か", "##な", "та", "##б"],
    )


def test_word_engine_unk_rollback_in_units():
    run_both("abcdex abcde", ["ab", "##c", "##d", "##e", "abcde"])
    run_both("中xyq 中", ["中", "x", "##y"])


def test_word_engine_pipelined_multichunk_matches_oracle():
    """Several pipeline chunks: the session, worker-thread prepares, the
    per-chunk device handles and the hybrid host-scalar path."""
    data = make_corpus(5_000_000)
    vocab = parse_vocab(make_vocab(data, vocab_size=8000))
    enc = enc_cpu(vocab)
    assert len(data) > enc.PIPELINE_CHUNK
    got = enc.encode_bytes(data)
    np.testing.assert_array_equal(got, oracle_ids(vocab, data))


def test_word_engine_hybrid_scalar_threshold_paths():
    data = make_corpus(4_200_000)
    vocab = parse_vocab(make_vocab(data, vocab_size=4000))
    dev = enc_cpu(vocab)
    dev.SCALAR_MAX_NEW = 0  # device kernel for every chunk
    host = enc_cpu(vocab)
    host.SCALAR_MAX_NEW = 1 << 30  # host oracle for all chunks after the first
    np.testing.assert_array_equal(dev.encode_bytes(data), host.encode_bytes(data))


def test_word_engine_random_bytes_fuzz():
    rng = np.random.default_rng(29)
    vocab = parse_vocab(
        ["[UNK]", "a", "b", "ab", "##a", "##b", "-", ".", "中", "х", "##х"]
        + [chr(c) for c in range(99, 122)]
    )
    enc = enc_cpu(vocab)
    handle = loader.VocabHandle(vocab)
    for trial in range(12):
        n = int(rng.integers(1, 4000))
        if trial % 3 == 0:
            data = bytes(rng.integers(0, 256, size=n, dtype=np.uint8))
        elif trial % 3 == 1:
            data = bytes(rng.integers(32, 127, size=n, dtype=np.uint8))
        else:
            data = ("х中a " * (n // 8)).encode() + bytes(
                rng.integers(128, 256, size=n % 8, dtype=np.uint8)
            )
        got = enc.encode_bytes(data).tolist()
        assert got == handle.encode(uni.decode_utf8(data)).tolist(), f"trial={trial}"


def test_word_engine_persistent_cache():
    data = make_corpus(400_000)
    vocab = parse_vocab(make_vocab(data, vocab_size=3000))
    enc = enc_cpu(vocab, cache=True)
    half = len(data) // 2
    while data[half] != 0x20:
        half += 1
    for chunk in (data[:half], data[:half], data[half:], data, b"zzznovel word"):
        np.testing.assert_array_equal(enc.encode_bytes(chunk), oracle_ids(vocab, chunk))
    enc.reset_cache()
    np.testing.assert_array_equal(enc.encode_bytes(data), oracle_ids(vocab, data))


def test_word_engine_edge_inputs():
    vocab = parse_vocab(["a", "b", "ab"])
    assert vocab.unk_token_id == -1
    enc = enc_cpu(vocab)
    for text in (b"ab zz a", b"", b"   ", b"\n\t  ", b"zzz", b"ab" * 500000 + b" q"):
        assert enc.encode_bytes(text).tolist() == oracle_ids(vocab, text).tolist(), text[:20]


def test_verify_emit_numpy_fallback(monkeypatch):
    vocab = parse_vocab(["[UNK]", "ab", "##c", "x"])
    enc = enc_cpu(vocab)
    monkeypatch.setattr(loader, "verify_emit", lambda *a, **k: None)
    mat = np.full((2, 7), 32, dtype=np.int32)
    mat[0, :3] = [ord("a"), ord("b"), ord("c")]
    mat[1, 0] = ord("x")
    emit = np.full((2, 7), -2, dtype=np.int32)
    emit[0, [0, 2]] = [1, 2]  # "ab" at 0, "##c" at 2
    emit[1, 0] = 3
    assert (enc._verify_emit(mat, emit) == emit).all()
    empty = np.full((2, 7), -2, dtype=np.int32)
    assert (enc._verify_emit(mat, empty) == empty).all()
    assert enc.verify_repairs == 0
    bad = emit.copy()
    bad[1, 0] = 1  # claims "ab" but the unit is "x"
    out = enc._verify_emit(mat, bad)
    assert out[1, 0] == 3 and (out[0] == emit[0]).all()
    assert enc.verify_repairs == 1
    oob = emit.copy()
    oob[0, 0] = 99
    out = enc._verify_emit(mat, oob)
    assert out[0, 0] == 1 and out[0, 1] == 2
    assert enc.verify_repairs == 2


def test_verify_emit_native_counts_repairs():
    """The native verifier's repairs are counted as the numpy path's are."""
    vocab = parse_vocab(["[UNK]", "ab", "##c", "x"])
    enc = enc_cpu(vocab)
    mat = np.full((2, 7), 32, dtype=np.int32)
    mat[0, :3] = [ord("a"), ord("b"), ord("c")]
    mat[1, 0] = ord("x")
    emit = np.full((2, 7), -2, dtype=np.int32)
    emit[0, [0, 2]] = [1, 2]  # "ab" at 0, "##c" at 2
    emit[1, 0] = 3
    assert (enc._verify_emit(mat, emit) == emit).all() and enc.verify_repairs == 0
    bad = emit.copy()
    bad[1, 0] = 1
    out = enc._verify_emit(mat, bad)
    assert (out == emit).all() and enc.verify_repairs == 1


def test_full_encode_with_numpy_verify(monkeypatch):
    monkeypatch.setattr(loader, "verify_emit", lambda *a, **k: None)
    run_both(
        "the quick brown fox zz9 jumps over the lazy dog " * 20,
        ["[UNK]", "the", "quick", "brown", "fox", "jump", "##s", "over",
         "lazy", "dog", "z", "##z", "##9"],
    )


def test_compact_overflow_falls_back_to_full_emit(monkeypatch):
    """A char-level vocabulary makes every ~15-char unit emit ~15 ids, so
    the total exceeds the compact cap (min 8192): the fetch must take the
    full-emit path and still match the oracle."""
    vocab = parse_vocab(
        ["[UNK]"] + list("abcdefghijklmnopqrstuvwxyz") + ["##" + c for c in "abcdefghijklmnopqrstuvwxyz"]
    )
    rng = np.random.default_rng(11)
    words = {"".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"), size=15)) for _ in range(1200)}
    data = " ".join(sorted(words)).encode()
    enc = enc_cpu(vocab)
    full_calls = []
    orig_full = enc._fetch_full

    def counting_full(*a, **k):
        full_calls.append(1)
        return orig_full(*a, **k)

    monkeypatch.setattr(enc, "_fetch_full", counting_full)
    np.testing.assert_array_equal(enc.encode_bytes(data), oracle_ids(vocab, data))
    assert full_calls, "compact cap did not overflow; fallback untested"
    assert enc.full_fetches == len(full_calls)
    assert enc.verify_repairs == 0


def test_cpu_path_launches_no_kernel():
    data = make_corpus(200_000)
    vocab = parse_vocab(make_vocab(data, vocab_size=3000))
    before = (wk.word_match_commit_multi.launches, wk.compact_from_counts.launches)
    enc = enc_cpu(vocab)
    np.testing.assert_array_equal(enc.encode_bytes(data), oracle_ids(vocab, data))
    assert (wk.word_match_commit_multi.launches, wk.compact_from_counts.launches) == before
    assert enc._stream is None and enc.dtables.packed.device.type == "cpu"


def test_stage_stats_and_trace():
    """StageStats sees every stage of a one-chunk encode; trace() records
    the plain version's torch ops and writes no file when given None."""
    data = make_corpus(200_000)
    vocab = parse_vocab(make_vocab(data, vocab_size=3000))
    enc = enc_cpu(vocab)
    enc.stats = StageStats()
    with trace(None) as prof:
        got = enc.encode_bytes(data)
    np.testing.assert_array_equal(got, oracle_ids(vocab, data))
    rep = enc.stats.report()
    for stage in ("host_segment_dedupe", "host_bucket_fill", "device_dispatch",
                  "device_fetch", "host_verify", "host_expand"):
        assert rep[stage]["calls"] == 1, stage
    assert rep["host_segment_dedupe"]["bytes"] == len(data)
    assert any(e.name.startswith("aten::") for e in prof.events())


def _auto_encoder():
    corpus = make_corpus(400_000)
    vocab = parse_vocab(make_vocab(corpus, vocab_size=3000))
    return corpus, vocab, enc_cpu(vocab, device_role="auto")


def test_device_role_auto_matches_primary():
    corpus, vocab, enc = _auto_encoder()
    want = enc_cpu(vocab, device_role="primary").encode_bytes(corpus)
    np.testing.assert_array_equal(enc.encode_bytes(corpus), want)
    assert enc.device_fallbacks == 0


def test_device_role_auto_rescues_stalled_fetch():
    """A fetch that reports a stall (TimeoutError) is rescued by the host
    oracle with identical ids; after DEVICE_DEAD_AFTER consecutive
    rescues the device latches dead (bounded rescue count)."""
    corpus = make_corpus(4_200_000)
    vocab = parse_vocab(make_vocab(corpus, vocab_size=4000))
    enc = enc_cpu(vocab, device_role="auto")

    def stalled_fetch(handle):
        raise TimeoutError("simulated stall")

    enc._fetch_buckets = stalled_fetch
    np.testing.assert_array_equal(enc.encode_bytes(corpus), oracle_ids(vocab, corpus))
    assert 1 <= enc.device_fallbacks <= enc.DEVICE_DEAD_AFTER
    assert enc._device_dead or enc.device_fallbacks < enc.DEVICE_DEAD_AFTER
    assert "simulated stall" in (enc.last_rescue_cause or "")


def test_device_role_auto_rescues_timeout():
    corpus, vocab, enc = _auto_encoder()
    enc.DEVICE_FETCH_TIMEOUT_S = 0.2
    enc.DEVICE_FIRST_FETCH_TIMEOUT_S = 0.2

    def hanging_fetch(handle):
        time.sleep(30.0)

    enc._fetch_buckets = hanging_fetch
    np.testing.assert_array_equal(enc.encode_bytes(corpus), oracle_ids(vocab, corpus))
    assert enc.device_fallbacks >= 1
    assert "Timeout" in (enc.last_rescue_cause or "")


def test_device_role_auto_timeout_raises_on_cuda():
    """On a CUDA encoder a missed deadline raises: the work the caller put
    on the card never moves to the CPU.  Only the rescue decision reads
    enc.device, so a CPU encoder relabelled as CUDA stands in for one."""
    corpus, _, enc = _auto_encoder()
    enc.device = torch.device("cuda")

    def stalled_fetch(handle):
        raise TimeoutError("simulated stall")

    enc._fetch_buckets = stalled_fetch
    with pytest.raises(TimeoutError, match="simulated stall"):
        enc.encode_bytes(corpus)
    assert enc.device_fallbacks == 0 and not enc._device_dead


def test_device_role_auto_host_bug_propagates():
    corpus, _, enc = _auto_encoder()

    def buggy_fetch(handle):
        raise IndexError("host-side decode bug")

    enc._fetch_buckets = buggy_fetch
    with pytest.raises(IndexError):
        enc.encode_bytes(corpus)
    assert enc.device_fallbacks == 0


def test_device_role_auto_cuda_error_propagates():
    """A CUDA error poisons the context: auto mode must not hide it behind
    a host rescue."""
    corpus, _, enc = _auto_encoder()

    def cuda_error_fetch(handle):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    enc._fetch_buckets = cuda_error_fetch
    with pytest.raises(RuntimeError, match="CUDA error"):
        enc.encode_bytes(corpus)
    assert enc.device_fallbacks == 0


def test_encode_codepoints_equal_jax():
    """WordEncoder.encode_codepoints, the JAX package's compatibility entry
    (codepoints re-encoded to UTF-8, then encode_bytes), equals the JAX
    WordEncoder's on a seeded text with CJK and astral codepoints, and the
    native oracle."""
    rng = np.random.default_rng(31)
    pool = list("abcdefgh") + ["中", "文", "𠀀", "𝔘", "é"]
    words = ["".join(rng.choice(pool, size=int(rng.integers(1, 10)))) for _ in range(400)]
    text = " ".join(words) + " 中文 mix-ed, 𠀀x 𝔘"
    lines = sorted({w[:2] for w in words} | {"##" + w[2:4] for w in words if len(w) > 3}
                   | set(pool) | {"##" + c for c in pool} | {"mix", "##ed", "-", ",", "[UNK]"})
    cps = np.array([ord(c) for c in text], dtype=np.int32)
    assert (cps >= 0x10000).any() and ((cps >= 0x4E00) & (cps < 0xA000)).any()
    got = enc_cpu(parse_vocab(lines)).encode_codepoints(cps)
    want = JaxWordEncoder(jax_parse_vocab(lines)).encode_codepoints(cps)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, oracle_ids(parse_vocab(lines), text.encode()))

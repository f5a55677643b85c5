"""The port's StageStats (self time, counters, updates from several
threads) and the stages and route counters the fast and linear engines
record: the caller thread's stages cover each call with its unstaged
rest, every first-seen unit is counted on exactly one route, and an
encoder with no StageStats attached never reaches it.  The fast-stream
engine's stages, each once a call, and its two size counters, likewise."""

import sys
import threading

import numpy as np
import pytest
import torch

from wordpiece_tpu_torch import make_encoder
from wordpiece_tpu_torch.bench.corpus import make_corpus, make_vocab
from wordpiece_tpu_torch.core import unicode as uni
from wordpiece_tpu_torch.core.vocab import parse_vocab
from wordpiece_tpu_torch.runtime import loader
from wordpiece_tpu_torch.utils import profiling
from wordpiece_tpu_torch.utils.profiling import StageStats

torch.set_num_threads(1)


class Clock:
    """A clock the test moves by hand."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(profiling, "_clock", c)
    return c


def test_self_time_of_nested_stages(clock):
    st = StageStats()
    with st.stage("outer", 10):
        clock.t = 1.0
        with st.stage("inner"):
            clock.t = 2.0
            with st.stage("leaf"):
                clock.t = 4.0
        clock.t = 5.0
        with st.stage("inner"):
            clock.t = 6.0
        clock.t = 10.0
    rep = st.report()
    assert rep["outer"] == {"seconds": 10.0, "self_seconds": 6.0, "calls": 1, "bytes": 10}
    assert rep["inner"] == {"seconds": 4.0, "self_seconds": 2.0, "calls": 2}
    assert rep["leaf"] == {"seconds": 2.0, "self_seconds": 2.0, "calls": 1}
    assert rep["counters"] == {}


def test_a_stage_on_another_thread_is_not_nested(clock):
    st = StageStats()

    def work():
        with st.stage("worker"):
            clock.t += 3.0

    with st.stage("caller"):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        clock.t = 10.0
    rep = st.report()
    assert rep["caller"]["self_seconds"] == 10.0 and rep["caller"]["seconds"] == 10.0
    assert rep["worker"]["self_seconds"] == 3.0


def test_updates_from_many_threads_are_all_kept():
    st = StageStats()
    n_threads, n_each = 8, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_each):
                with st.stage("shared", 3):
                    pass
                st.count("hits")

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    rep = st.report()
    assert rep["shared"]["calls"] == n_threads * n_each
    assert rep["shared"]["bytes"] == 3 * n_threads * n_each
    assert rep["counters"] == {"hits": n_threads * n_each}


def test_count_and_reset(clock):
    st = StageStats()
    st.count("a")
    st.count("a", 4)
    st.count("b", -2)
    with st.stage("s", 5):
        clock.t = 1.0
    rep = st.report()
    assert rep["counters"] == {"a": 5, "b": -2}
    assert set(rep["s"]) == {"seconds", "self_seconds", "calls", "bytes"}
    assert all(isinstance(v, int) for v in rep["counters"].values())
    st.reset()
    assert st.report() == {"counters": {}}
    assert not st.self_times and not st.times and not st.calls and not st.bytes


# The stages each engine opens directly inside `encode` on the caller's
# thread; what they leave of the call is encode's self time.
CALLER = {
    "fast": ("host_split", "wait_worker", "device_fetch", "host_verify", "host_stitch",
             "host_expand", "host_concat"),
    "linear": ("host_split", "wait_worker", "host_join", "device_dispatch", "device_fetch",
               "host_stitch", "host_concat", "host_expand"),
}
STAGES = ("encode", "host_split", "wait_worker", "device_wait", "fetch_unpack", "host_stitch", "host_concat",
          "device_fetch", "host_segment_dedupe", "host_expand")


@pytest.fixture(scope="module")
def corpus():
    data = make_corpus(300_000)
    vocab = parse_vocab(make_vocab(data, vocab_size=3000))
    want = loader.VocabHandle(vocab).encode(uni.decode_utf8(data))
    n_units = loader.segment_dedupe(data)[1].shape[0]
    return data, vocab, want, n_units


def chunked(engine: str, vocab):
    """The benchmark's encoder (make_encoder) with the pipeline cut into
    many small pieces."""
    enc = make_encoder(vocab, engine, device="cpu")
    if engine == "fast":
        enc.PIPELINE_FIRST = 40_000
        enc.PIPELINE_CHUNK = 50_000
        enc.SCALAR_MAX_NEW = 1000
    else:
        enc.LINEAR_SEG_CHUNK = 50_000
        enc.LINEAR_BATCH_TARGET = 20_000
    return enc


@pytest.mark.skipif(not loader.available(), reason="native runtime required")
@pytest.mark.parametrize("engine", ["fast", "linear"])
def test_stages_and_routes_of_a_chunked_encode(engine, corpus):
    data, vocab, want, n_units = corpus
    enc = chunked(engine, vocab)
    enc.stats = StageStats()
    for calls in (1, 2):
        np.testing.assert_array_equal(enc.encode_bytes(data), want)
        rep = enc.stats.report()
        for stage in STAGES:
            assert rep[stage]["calls"] >= 1, stage
        assert rep["encode"]["calls"] == calls and rep["encode"]["bytes"] == calls * len(data)
        assert rep["host_segment_dedupe"]["calls"] > 3 * calls
        assert rep["host_segment_dedupe"]["bytes"] == calls * len(data)
        staged = sum(rep[s]["seconds"] for s in CALLER[engine] if s in rep)
        assert staged + rep["encode"]["self_seconds"] == pytest.approx(rep["encode"]["seconds"], rel=0.01)
        c = rep["counters"]
        assert c["units_new"] == calls * n_units
        assert c["units_new"] == c["units_card"] + c.get("units_host", 0)
        assert c["units_card"] > 0
        if engine == "fast":  # the tail, the 1-2 codepoint units
            assert c["units_host"] > 0
        else:  # every unit goes to the card in a batch
            assert c["units_card"] == c["units_new"]


@pytest.mark.skipif(not loader.available(), reason="native runtime required")
def test_a_one_chunk_fast_encode_waits_on_no_worker(corpus):
    data, vocab, want, n_units = corpus
    enc = make_encoder(vocab, "fast", device="cpu")
    enc.stats = StageStats()
    np.testing.assert_array_equal(enc.encode_bytes(data), want)
    rep = enc.stats.report()
    assert not {"host_split", "wait_worker", "host_concat"} & set(rep)
    assert rep["encode"]["calls"] == 1 and rep["device_wait"]["calls"] == 1
    c = rep["counters"]
    assert c["units_new"] == n_units == c["units_card"] + c["units_host"]


@pytest.mark.skipif(not loader.available(), reason="native runtime required")
def test_rescued_chunks_count_on_the_host(corpus):
    data, vocab, want, n_units = corpus
    enc = chunked("fast", vocab)

    def stalled_fetch(handle):
        raise TimeoutError("simulated stall")

    enc._fetch_buckets = stalled_fetch
    enc.stats = StageStats()
    np.testing.assert_array_equal(enc.encode_bytes(data), want)
    assert enc.device_fallbacks >= 1
    c = enc.stats.report()["counters"]
    assert c == {"units_new": n_units, "units_card": 0, "units_host": n_units}


@pytest.mark.skipif(not loader.available(), reason="native runtime required")
@pytest.mark.parametrize("engine", ["fast", "linear"])
def test_without_stats_nothing_is_recorded(engine, corpus, monkeypatch):
    data, vocab, want, _ = corpus

    def boom(*a, **k):
        raise AssertionError("StageStats reached with no stats attached")

    monkeypatch.setattr(StageStats, "stage", boom)
    monkeypatch.setattr(StageStats, "count", boom)
    enc = chunked(engine, vocab)
    assert enc.stats is None
    np.testing.assert_array_equal(enc.encode_bytes(data), want)


# The fast-stream engine: every stage on the caller's thread, once a call;
# encode_bytes decodes inside stream_h2d (the count) and device_dispatch
# (the write), so it has no host_decode.
STREAM_CALLER = ("host_pad", "stream_h2d", "device_dispatch", "device_fetch")
STREAM_STAGES = ("encode",) + STREAM_CALLER + ("device_wait", "fetch_unpack")


@pytest.fixture(scope="module")
def stream_corpus():
    data = make_corpus(60_000, seed=5)
    vocab = parse_vocab(make_vocab(data, vocab_size=1000, seed=5))
    return data, vocab


def test_stream_stages_of_one_encode(stream_corpus):
    from wordpiece_tpu_torch.engine import bucket_size

    data, vocab = stream_corpus
    enc = make_encoder(vocab, "fast-stream", device="cpu")
    cps = uni.decode_utf8(data)
    want = enc.encode_codepoints(cps)
    enc.stats = StageStats()
    for calls in (1, 2):
        np.testing.assert_array_equal(enc.encode_bytes(data), want)
        rep = enc.stats.report()
        assert set(rep) == set(STREAM_STAGES) | {"counters"}
        assert all(rep[s]["calls"] == calls for s in STREAM_STAGES)
        assert rep["encode"]["bytes"] == calls * len(data)
        staged = sum(rep[s]["seconds"] for s in STREAM_CALLER)
        assert staged + rep["encode"]["self_seconds"] == pytest.approx(rep["encode"]["seconds"], rel=0.01)
        assert rep["device_fetch"]["seconds"] >= rep["device_wait"]["seconds"] + rep["fetch_unpack"]["seconds"]
        assert rep["counters"] == {"stream_pieces": calls,
                                   "stream_positions": calls * bucket_size(cps.shape[0]),
                                   "stream_table_rows": calls * enc.table.slots.shape[0],
                                   "stream_card_decoded_bytes": 0}


@pytest.mark.parametrize("text", [b"", b"\xff\xfe\x80", "na\u00efve caf\u00e9".encode()],
                         ids=["empty", "all_invalid", "two_byte"])
def test_stream_card_decoded_bytes_is_0_on_the_cpu(stream_corpus, text):
    """The counter is counted once a call of encode_bytes, also where the
    call has no codepoint, and reads 0 where the plain decode ran."""
    _, vocab = stream_corpus
    enc = make_encoder(vocab, "fast-stream", device="cpu")
    enc.stats = StageStats()
    cps = uni.decode_utf8(text)
    np.testing.assert_array_equal(enc.encode_bytes(text), enc.encode_codepoints(cps))
    rep = enc.stats.report()
    assert rep["counters"]["stream_card_decoded_bytes"] == 0
    # encode_bytes counts before it knows the count; encode_codepoints
    # stages nothing for no codepoint.
    assert rep["encode"]["calls"] == 2 and rep["stream_h2d"]["calls"] == 1 + bool(cps.size)


def test_stream_encode_codepoints_opens_encode_once_and_no_decode(stream_corpus):
    data, vocab = stream_corpus
    enc = make_encoder(vocab, "fast-stream", device="cpu")
    enc.stats = StageStats()
    enc.encode_codepoints(uni.decode_utf8(data))
    rep = enc.stats.report()
    assert "host_decode" not in rep and rep["encode"]["calls"] == 1 and rep["host_pad"]["calls"] == 1


def test_stream_without_stats_nothing_is_recorded(stream_corpus, monkeypatch):
    data, vocab = stream_corpus
    enc = make_encoder(vocab, "fast-stream", device="cpu")
    want = enc.encode_bytes(data)

    def boom(*a, **k):
        raise AssertionError("StageStats reached with no stats attached")

    monkeypatch.setattr(StageStats, "stage", boom)
    monkeypatch.setattr(StageStats, "count", boom)
    assert enc.stats is None
    np.testing.assert_array_equal(enc.encode_bytes(data), want)
    np.testing.assert_array_equal(enc.encode_codepoints(uni.decode_utf8(data)), want)

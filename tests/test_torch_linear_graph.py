"""The linear engine's CUDA-graph path, on the CPU: the graph key, the
inert padding that lets one graph serve every length of a bucket, and the
engine's bookkeeping around replays (static buffers, the overflow re-run,
the counters) with the capture stubbed by a stand-in that keeps a CUDA
graph's contract.  Ids are integers: exact."""

import numpy as np
import pytest
import torch

from wordpiece_tpu_torch import engine_linear as el
from wordpiece_tpu_torch.bench.corpus import make_corpus, make_vocab
from wordpiece_tpu_torch.core import unicode as uni
from wordpiece_tpu_torch.core.vocab import parse_vocab
from wordpiece_tpu_torch.runtime import loader
from wordpiece_tpu_torch.utils.profiling import StageStats

torch.set_num_threads(1)

HAND_VOCAB = ["[UNK]", "hello", "he", "##llo", "q", "##q", "##x", "中", "文", "##文", "a", "##b",
              "ab", "-", "##-", "\U00020000", "##\U00020000"]
COUNTERS = ("batches_graph", "batches_eager", "graph_captures")


def oracle_ids(vocab, data: bytes) -> np.ndarray:
    return loader.VocabHandle(vocab).encode(uni.decode_utf8(data))


def en_case(size=60_000, vocab_size=2000):
    data = make_corpus(size, lang="en")
    return data, parse_vocab(make_vocab(data, vocab_size=vocab_size))


class StubGraph:
    """A CUDA graph's contract on the CPU: the capture gives the program's
    outputs, and every replay runs the program again on the static inputs
    it was captured with, into those same outputs."""

    def __init__(self, run):
        self.run = run
        self.out = run()
        self.replays = 0

    def replay(self):
        for static, new in zip(self.out, self.run()):
            static.copy_(new)
        self.replays += 1


def on_stub_card(enc, monkeypatch):
    """The encoder takes the card's graph path, with the stub capture."""
    graphs = []

    def capture(run, stream, pool):
        graphs.append(StubGraph(run))
        return graphs[-1], graphs[-1].out

    monkeypatch.setattr(el, "_capture", capture)
    enc._graphs = {}
    enc.stats = StageStats()
    return graphs


def counters(enc) -> dict:
    c = enc.stats.report()["counters"]
    return {k: c.get(k, 0) for k in COUNTERS}


def test_graph_key_reads_bucket_cap_and_dtypes():
    _, vocab = en_case(20_000, 600)
    enc = el.LinearEncoder(vocab, device="cpu")
    ascii_a = np.frombuffer(b"hello world " * 300, dtype=np.uint8).astype(np.int32)
    x, c, cap = enc.batch_inputs(ascii_a)
    assert el.graph_key(x, c, cap) == (el._bucket(ascii_a.shape[0]), cap, "<u2", "<u2")
    # Another length of the same bucket and cap shares the graph.
    x2, c2, cap2 = enc.batch_inputs(ascii_a[:-7])
    assert cap2 == cap and el.graph_key(x2, c2, cap2) == el.graph_key(x, c, cap)
    # A codepoint above U+FFFF widens the codepoints, and the key with them.
    astral = ascii_a.copy()
    astral[5] = 0x20000
    xa, ca, capa = enc.batch_inputs(astral)
    assert ca.dtype == np.int32 and el.graph_key(xa, ca, capa)[3] == "<i4"
    assert el.graph_key(xa, ca, capa)[:3] == el.graph_key(x, c, cap)[:3]
    # A wider dense alphabet, another bucket, another cap: other keys.
    assert el.graph_key(x.astype(np.int32), c, cap)[2] == "<i4"
    xb, cb, capb = enc.batch_inputs(np.concatenate([ascii_a, ascii_a]))
    assert el.graph_key(xb, cb, capb)[0] == el._bucket(2 * ascii_a.shape[0]) != x.shape[0]
    assert el.graph_key(x, c, cap + 1) != el.graph_key(x, c, cap)


@pytest.mark.parametrize("text", [
    "hello he",  # ends at a unit
    "hello qqqz",  # ends in a rolled-back [UNK] word
    "qqqzx hello qq",  # a rolled-back word inside
    "hello   \t ",  # trailing spaces
    "ab 中文",  # CJK at the end
    "ab中文中",  # CJK inside a run
    "qq\U00020000 \U00020000",  # above U+FFFF
    "he-llo-",  # punctuation at the end
    "q" * 300,  # one long unit
])
def test_padding_is_inert(text):
    """The batch program at the padded length gives the true length's ids,
    positions and count: pads are spaces and the pad symbol, which match
    nothing and which the commit skips."""
    vocab = parse_vocab(HAND_VOCAB)
    enc = el.LinearEncoder(vocab, device="cpu")
    cps = uni.decode_utf8(text.encode()).astype(np.int32)
    n = int(cps.shape[0])
    x, c, cap = enc.batch_inputs(cps)
    assert x.shape[0] > n
    m = enc._merge
    args = [torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16 else a) for a in (x, c)]
    tabs = (m.tok_keys, m.tok_len, m.tok_id, m.tok_kind)
    statics = dict(bits=m.bits, per=m.per, nk=m.nk, max_len=enc.max_len, unk_id=enc._unk_id)
    ids_n, pos_n, count_n = el._linear_batch_core(*args, n, *tabs, **statics)
    ids_p, pos_p, count_p = el._linear_batch_core(*args, x.shape[0], *tabs, **statics)
    k = int(count_n)
    assert int(count_p) == k
    assert torch.equal(ids_p[:k], ids_n[:k]) and torch.equal(pos_p[:k], pos_n[:k])
    assert ids_p[:k].tolist() == oracle_ids(vocab, text.encode()).tolist()
    fused = enc._program(*args, cap)[0]
    assert int(fused[0]) == k and fused[1 : 1 + k].tolist() == ids_n[:k].tolist()


def test_padding_is_inert_at_every_cut():
    """Cuts of an en corpus at lengths all over their buckets."""
    data, vocab = en_case(20_000, 600)
    enc = el.LinearEncoder(vocab, device="cpu")
    cps_all = uni.decode_utf8(data).astype(np.int32)
    m = enc._merge
    tabs = (m.tok_keys, m.tok_len, m.tok_id, m.tok_kind)
    statics = dict(bits=m.bits, per=m.per, nk=m.nk, max_len=enc.max_len, unk_id=enc._unk_id)
    for n in (1, 97, 129, 190, 1000, 1535, 3073, 5000):
        cps = cps_all[:n]
        x, c, _ = enc.batch_inputs(cps)
        args = [torch.from_numpy(a.view(np.int16)) for a in (x, c)]
        got = [el._linear_batch_core(*args, length, *tabs, **statics) for length in (n, x.shape[0])]
        k = int(got[0][2])
        assert int(got[1][2]) == k, n
        for a, b in zip(got[0][:2], got[1][:2]):
            assert torch.equal(a[:k], b[:k]), n


def test_stub_card_pipeline_replays_and_counts(monkeypatch):
    """Many batches in flight through replays of a few graphs: the ids
    equal the oracle's (each batch's compact vector is copied before the
    next replay overwrites it), every batch is a graph's or eager, and a
    replay is counted in graph_replays, never in a kernel wrapper's
    .launches (which count the wrappers' own calls alone)."""
    data, vocab = en_case(200_000)
    enc = el.LinearEncoder(vocab, device="cpu")
    graphs = on_stub_card(enc, monkeypatch)
    enc.LINEAR_SEG_CHUNK = 20_000
    enc.LINEAR_BATCH_TARGET = 2_000
    wrappers = (el.compute_features, el.match_from_sa, el.commit_ops.commit_with_positions)
    before = [f.launches for f in wrappers]
    got = enc.encode_bytes(data)
    assert np.array_equal(got, oracle_ids(vocab, data))
    c = counters(enc)
    assert c["batches_graph"] + c["batches_eager"] == enc.device_batches > 3 * enc.PIPELINE_WINDOW
    assert c["graph_captures"] == len(enc._graphs) == len(graphs) == c["batches_eager"]
    assert c["batches_graph"] == sum(g.replays for g in graphs) > c["batches_eager"]
    assert enc.graph_replays == c["batches_graph"]
    assert [f.launches for f in wrappers] == before  # CPU tensors: no launch to count
    # A second call replays every batch: its keys were all seen.
    enc.stats.reset()
    assert np.array_equal(enc.encode_bytes(data), got)
    assert counters(enc)["batches_eager"] <= 1
    # One-shot batches of the codepoint path share the graphs.
    cps = np.asarray(uni.decode_utf8(data[:5_000]), dtype=np.int32)
    assert enc.encode_codepoints(cps).tolist() == oracle_ids(vocab, data[:5_000]).tolist()


def test_stub_card_overflow_reruns_the_batch(monkeypatch):
    """count > cap on a graph's batch: the batch runs again as launches,
    equal to the full fetch of the CPU path, counted in full_fetches and as
    an eager batch."""
    data, _ = en_case(60_000)
    chars = sorted(set("".join(data.decode("utf-8", errors="ignore").split())))
    vocab = parse_vocab(["[UNK]"] + chars + ["##" + ch for ch in chars])
    plain = el.LinearEncoder(vocab, device="cpu")
    plain._cap_ratio = 0.0001
    plain.LINEAR_BATCH_TARGET = 12_000
    want = plain.encode_bytes(data)
    assert plain.full_fetches > 0
    assert np.array_equal(want, oracle_ids(vocab, data))

    enc = el.LinearEncoder(vocab, device="cpu")
    graphs = on_stub_card(enc, monkeypatch)
    enc.LINEAR_BATCH_TARGET = 12_000
    # Warm the graphs at the starting cap, then force the cap below the
    # id count again: the next batches overflow on a replay.
    enc._cap_ratio = 0.0001
    enc.encode_bytes(data)
    enc.stats.reset()
    enc._cap_ratio = 0.0001
    fetches, batches = enc.full_fetches, enc.device_batches
    got = enc.encode_bytes(data)
    assert np.array_equal(got, want)
    c = counters(enc)
    reruns = enc.full_fetches - fetches
    assert reruns > 0 and c["batches_graph"] > 0
    assert c["batches_graph"] + c["batches_eager"] == enc.device_batches - batches
    assert c["batches_eager"] == reruns + c["graph_captures"]
    assert sum(g.replays for g in graphs) >= c["batches_graph"]


def test_cpu_and_doubling_fallback_take_no_graph(monkeypatch):
    def no_capture(run, stream, pool):
        raise AssertionError("a capture on a path that takes no graph")

    monkeypatch.setattr(el, "_capture", no_capture)
    data, vocab = en_case(30_000, 600)
    enc = el.LinearEncoder(vocab, device="cpu")
    enc.stats = StageStats()
    assert enc._graphs is None and enc._capture_stream is None
    assert np.array_equal(enc.encode_bytes(data), oracle_ids(vocab, data))
    assert enc.device_batches > 0 and counters(enc) == dict.fromkeys(COUNTERS, 0)

    # The doubling fallback (nk > 24) runs as launches even on the card's
    # path: every batch eager, no capture.
    rng = np.random.default_rng(11)
    syms = 0x100 + rng.permutation(1100)
    longs = ["".join(chr(ch) for ch in syms[i : i + 50]) for i in range(0, 1100, 50)]
    singles = sorted({chr(ch) for ch in syms[:40]})
    d_vocab = parse_vocab(["[UNK]"] + longs + singles + ["##" + ch for ch in singles])
    text = " ".join(longs[int(i) % 6] for i in rng.integers(0, 6, size=20)).encode()
    enc = el.LinearEncoder(d_vocab, device="cpu")
    assert enc._merge is None
    enc._graphs = {}
    enc.stats = StageStats()
    assert np.array_equal(enc.encode_bytes(text), oracle_ids(d_vocab, text))
    c = counters(enc)
    assert enc._graphs == {} and c["batches_graph"] == c["graph_captures"] == 0
    assert c["batches_eager"] == enc.device_batches > 0


def test_card_staging_views_and_reuse(monkeypatch):
    """The card's staging buffer (unpinned here): the inputs copied into
    16-byte aligned views of one slot, the compact vector's view after
    them; a fetched batch's slot is reused, a smaller free one is replaced
    by one of the size asked, and at most PIPELINE_WINDOW + 1 free slots
    are kept."""
    _, vocab = en_case(20_000, 600)
    enc = el.LinearEncoder(vocab, device="cpu")
    made = []
    empty = torch.empty

    def pinned_as_plain(*shape, pin_memory=False, **kw):
        t = empty(*shape, **kw)
        if pin_memory:  # a staging slot
            made.append(t)
        return t

    monkeypatch.setattr(el.torch, "empty", pinned_as_plain)
    enc._stream = "card"  # _staged's card branch only; no stream is entered
    cps = np.frombuffer(b"hello world " * 90 + "\U00020000".encode("utf-32-le"),
                        dtype=np.uint8).astype(np.int32)[:1001]
    x, c, cap = enc.batch_inputs(cps)
    buf, xs, cs, host = enc._staged(x, c, 1 + 2 * cap)
    assert buf is made[0] and xs.dtype == torch.int16 and cs.dtype == torch.int16
    assert xs.numpy().view(np.uint16).tolist() == x.tolist()
    assert cs.numpy().view(np.uint16).tolist() == c.tolist()
    assert host.dtype == torch.int32 and host.shape == (1 + 2 * cap,)
    views = (xs, cs, host)
    starts = [v.data_ptr() - buf.data_ptr() for v in views]
    assert all(s % 16 == 0 for s in starts)
    assert all(s + v.numel() * v.element_size() <= e for s, v, e in
               zip(starts, views, starts[1:] + [buf.numel()]))
    enc._release(buf)
    assert enc._staged(x, c, 1 + 2 * cap)[0] is buf and len(made) == 1
    enc._release(buf)
    enc._release(empty(16, dtype=torch.uint8))  # the last freed, too small
    big = enc._staged(x, c, 1 + 2 * cap)[0]
    assert big is made[-1] and len(made) == 2 and big.numel() == buf.numel()
    assert enc._free_slots == [buf]
    for n in range(enc.PIPELINE_WINDOW + 3):
        enc._release(empty(1024, dtype=torch.uint8))
    assert len(enc._free_slots) == enc.PIPELINE_WINDOW + 1 and enc._free_slots[0] is buf

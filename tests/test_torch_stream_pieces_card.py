"""The whole-text engine's pieces on the card (engine.FastEncoder on
device="cuda"): a 10 MB en-like document through encode_bytes gives the
ids of the whole text as one program and holds one cap-sized bucket's
arrays on the card at a time; the decode's count hands over the tiles'
prefixes of the plain version, from which Offsets places every
codepoint; the write of a document's head from the document's count is the
head's own decode; and a count the caller expects is checked after a later
read.  Marked `chip`: each test skips without a CUDA device.  On the card:

    python -m pytest tests/test_torch_stream_pieces_card.py -m chip -q
"""

import numpy as np
import pytest
import torch

from wordpiece_tpu_torch import engine
from wordpiece_tpu_torch.bench.corpus import make_corpus, make_vocab
from wordpiece_tpu_torch.core.vocab import parse_vocab
from wordpiece_tpu_torch.ops import utf8_decode as ud
from wordpiece_tpu_torch.utils.profiling import StageStats

pytestmark = pytest.mark.chip

BYTES_A_POSITION = 36  # the per-position arrays of one piece: the bucket, features, matches, commit


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def on_card(data: bytes, dev) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(data, dtype=np.uint8).copy()).to(dev)


def test_a_10MB_document_runs_in_cap_sized_pieces(card):
    data = make_corpus(10_000_000, seed=61)
    enc = engine.FastEncoder(parse_vocab(make_vocab(data[:2_000_000], vocab_size=28_996, seed=61)),
                             device=card)
    st = enc._statics
    counted = ud.count_codepoints(on_card(data, card))
    n = counted.n
    assert n > engine.LADDER_CAP
    cp_pad = ud.write_codepoints(counted, engine.bucket_size(n) + st["max_len"])
    del counted
    ids, count = engine.encode_padded(cp_pad, n, enc.table, **st)
    want = ids[: int(count)].cpu().numpy()
    del cp_pad, ids, count

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()  # the probe table and what the process holds
    enc.stats = StageStats()
    got = enc.encode_bytes(data)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - resident
    np.testing.assert_array_equal(got, want)
    counters = enc.stats.report()["counters"]
    assert counters["stream_pieces"] == -(-n // engine.LADDER_CAP)
    assert counters["stream_positions"] < engine.bucket_size(n)
    assert counters["stream_card_decoded_bytes"] == len(data)
    assert peak <= BYTES_A_POSITION * (engine.LADDER_CAP + st["max_len"]) + 16_000_000, peak


def test_the_count_hands_over_the_tiles_prefixes_and_a_head(card):
    rng = np.random.default_rng(67)
    text = b" ".join(make_corpus(400_000, lang=lang, seed=67) for lang in ("en", "ru", "zh", "ja"))
    data = bytearray(text)
    for at in sorted(rng.integers(0, len(data), 300).tolist(), reverse=True):
        data[at:at] = bytes([int(rng.integers(0x80, 0x100))])
    data = bytes(data)
    plain = ud.count_codepoints(torch.from_numpy(np.frombuffer(data, np.uint8).copy()), prefixes=True)
    got = ud.count_codepoints(on_card(data, card), prefixes=True)
    assert got.n == plain.n
    tile, prefixes = got.tiles
    every = plain.tiles[1]  # one byte a tile on the CPU
    ends = np.minimum(np.arange(tile, len(data) + tile, tile), len(data)) - 1
    np.testing.assert_array_equal(prefixes, every[ends])
    at = ud.Offsets(got, data)
    starts = np.flatnonzero(ud.lead_mask(np.frombuffer(data, np.uint8)))
    for k in rng.integers(0, got.n, 2000).tolist() + [0, got.n - 1]:
        assert at.byte_of(k) == starts[k]
    for b in rng.integers(0, len(data) + 1, 2000).tolist() + [0, tile, len(data)]:
        assert at.codepoints_before(b) == (every[b - 1] if b else 0)
    cut = data.index(b" ", len(data) // 2 + 12_345)
    k = at.codepoints_before(cut)
    bucket = ud.write_codepoints(ud.head(got, cut, k), k + 1000).cpu()
    np.testing.assert_array_equal(bucket[:k].numpy(), ud.decode_plain(torch.from_numpy(
        np.frombuffer(data[:cut], np.uint8).copy())).numpy())
    assert not bucket[k:].any()


def test_an_expected_count_is_checked_after_a_later_read(card):
    """count_codepoints(expect=k) on a card waits for nothing; check, after
    a read of the device, passes on the true count and raises on another."""
    data = make_corpus(100_000, lang="ru", seed=71)
    n = ud.count_codepoints(on_card(data, card)).n
    for k, ok in ((n, True), (n - 1, False)):
        counted = ud.count_codepoints(on_card(data, card), expect=k)
        assert counted.n == k and counted.found is not None
        torch.cuda.synchronize()
        if ok:
            ud.check(counted)
        else:
            with pytest.raises(RuntimeError):
                ud.check(counted)

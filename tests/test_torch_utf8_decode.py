"""The whole-text engine's UTF-8 decode (ops/utf8_decode.py): its plain
version against core/unicode.decode_utf8, both its numpy path and the
native decoder, on every 1- and 2-byte string, every lead byte before
continuation and other bytes, sequences cut off by the end, the empty
input and seeded random strings; the bucket its two passes write; its
wrapper's checks; and FastEncoder(device="cpu").encode_bytes against
encode_codepoints of decode_utf8 on the golden texts and on invalid UTF-8.
chip_smoke.py holds the kernels (csrc/utf8_decode.cu) to the plain
version on the card.  Integers: exact."""

import glob
import itertools
import os

import numpy as np
import pytest
import torch

from wordpiece_tpu_torch import engine
from wordpiece_tpu_torch.bench.corpus import make_corpus, make_vocab
from wordpiece_tpu_torch.core import unicode as uni
from wordpiece_tpu_torch.core.vocab import parse_vocab
from wordpiece_tpu_torch.engine import FastEncoder, pad_codepoints
from wordpiece_tpu_torch.ops import utf8_decode as ud
from wordpiece_tpu_torch.runtime import loader

torch.set_num_threads(1)

GOLDEN = sorted(glob.glob(os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                                       "golden_*.npz")))
# Bytes at the edges of the decoder's ranges: ASCII, continuation bytes at
# the limits of the overlong, surrogate and past-U+10FFFF checks, leads of
# every length, and bytes that lead nothing.
EDGE = bytes([0x00, 0x20, 0x41, 0x7F, 0x80, 0x8F, 0x90, 0x9F, 0xA0, 0xBF, 0xC0, 0xC1, 0xC2,
              0xDF, 0xE0, 0xE1, 0xEC, 0xED, 0xEE, 0xEF, 0xF0, 0xF1, 0xF3, 0xF4, 0xF5, 0xF7,
              0xF8, 0xFB, 0xFC, 0xFE, 0xFF])
# What follows a lead in the 3- and 4-byte forms: continuation bytes at
# the checks' limits, and bytes that continue nothing.
FOLLOW = bytes([0x80, 0x8F, 0x90, 0x9F, 0xA0, 0xBF, 0x00, 0x41, 0xC2, 0xE0, 0xF0, 0xFF])


def as_tensor(data: bytes) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(data, dtype=np.uint8).copy())


def check(data: bytes) -> np.ndarray:
    """The plain decode of data, held to decode_utf8's numpy path and to
    the native decoder at any length; returns it."""
    got = ud.decode_plain(as_tensor(data)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got.astype(np.uint32), uni.decode_utf8(data, native=False))
    native = loader.decode_utf8(data) if loader.available() else None
    if native is not None:
        np.testing.assert_array_equal(got.astype(np.uint32), native)
    return got


def test_every_one_byte_string_alone():
    for b in range(256):
        check(bytes([b]))


@pytest.mark.parametrize("sep", [b"", b"\n"], ids=["back_to_back", "separated"])
def test_every_two_byte_string(sep):
    """Back to back every pair also meets its neighbours; a newline after
    each holds it alone (it continues nothing)."""
    data = sep.join(bytes(p) for p in itertools.product(range(256), repeat=2)) + sep
    assert len(check(data)) > 0


def test_three_and_four_byte_forms():
    """Every lead byte from 0xC0, followed by continuation bytes at the
    limits and by bytes that continue nothing, three deep: overlongs,
    surrogates, values past U+10FFFF and 0xF5-0xFF leads among them."""
    data = b"\n".join(bytes([lead, *rest]) for lead in range(0xC0, 0x100)
                      for rest in itertools.product(FOLLOW, repeat=3))
    got = check(data + b"\n")
    assert {0x80, 0x800, 0xD7FF, 0xE000, 0x10000, 0x10FFFF} - set(got.tolist()) == set()
    assert not ((got >= 0xD800) & (got <= 0xDFFF)).any() and got.max() <= 0x10FFFF


@pytest.mark.parametrize("char", ["é", "߿", "€", "中", "￿", "\U0001f600",
                                  "\U0010ffff"])
def test_sequences_cut_off_by_the_end(char):
    seq = char.encode()
    for cut in range(1, len(seq) + 1):
        got = check(b"ab " + seq[:cut])
        assert got.tolist() == [97, 98, 32] + ([ord(char)] if cut == len(seq) else [])
        check(seq[:cut])


def test_lone_leads_at_the_end():
    for lead in range(0xC0, 0x100):
        assert check(b"x" + bytes([lead])).tolist() == [ord("x")]


def test_empty():
    assert check(b"").shape == (0,)


@pytest.mark.parametrize("seed", range(8))
def test_random_strings(seed):
    """Uniform bytes on even seeds, the edge pool on odd ones; lengths
    around the native decoder's 4,096-byte threshold and the kernels'
    4,096-byte tiles."""
    rng = np.random.default_rng(seed)
    for length in (1, 5, 4095, 4096, 4097, 8195, int(rng.integers(0, 12_000))):
        if seed % 2:
            data = bytes(np.frombuffer(EDGE, np.uint8)[rng.integers(0, len(EDGE), length)])
        else:
            data = rng.integers(0, 256, length, dtype=np.uint8).tobytes()
        check(data)


@pytest.mark.parametrize("data", [b"", b"\xff\xfe", "café 中\U0001f600 x\xed".encode()],
                         ids=["empty", "all_invalid", "mixed"])
@pytest.mark.parametrize("extra", [0, 1, 130])
def test_the_bucket(data, extra):
    """The two passes: the count, then the codepoints and zeros up to size."""
    counted = ud.count_codepoints(as_tensor(data))
    want = uni.decode_utf8(data).astype(np.int32)
    assert counted.n == want.shape[0]
    out = ud.write_codepoints(counted, counted.n + extra)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.concatenate([want, np.zeros(extra, np.int32)]))


def edge_text(seed: int, most: int) -> bytes:
    rng = np.random.default_rng(seed)
    return bytes(rng.choice(np.frombuffer(EDGE + FOLLOW + "ж中▁𠀀".encode(), np.uint8),
                            int(rng.integers(1, most))))


@pytest.mark.parametrize("seed", range(3))
def test_lead_mask_and_tile_prefixes(seed):
    """The rule on numpy bytes marks the bytes the decode keeps, and the
    count's prefixes are the codepoints up to the end of each tile: on the
    CPU a tile is one byte."""
    data = edge_text(seed, 3 * 4096)
    mask = ud.lead_mask(np.frombuffer(data, np.uint8))
    assert mask.dtype == np.bool_
    np.testing.assert_array_equal(mask, ud.lead_mask(as_tensor(data)).numpy())
    counted = ud.count_codepoints(as_tensor(data), prefixes=True)
    np.testing.assert_array_equal(counted.state.numpy(), check(data))
    tile, prefixes = counted.tiles
    assert tile == 1 and prefixes.tolist() == np.cumsum(mask).tolist()
    assert prefixes[-1] == counted.n and ud.count_codepoints(as_tensor(data)).tiles is None


def coarse(counted: ud.Counted, tile: int) -> ud.Counted:
    """A CPU count's prefixes at `tile` bytes a tile, as the kernel's."""
    _, every = counted.tiles
    ends = np.minimum(np.arange(tile, every.shape[0] + tile, tile), every.shape[0]) - 1
    return counted._replace(tiles=(tile, every[ends]))


@pytest.mark.parametrize("tile", [1, 16, 4096])
@pytest.mark.parametrize("seed", range(3))
def test_offsets_at_any_tile(seed, tile):
    """Offsets from a count's tile prefixes: the byte where each codepoint
    begins, the codepoints before each byte, for ASCII and edge-byte text
    (a tile where every byte leads, and one where not)."""
    data = edge_text(seed, 3 * 4096) + make_corpus(5000, seed=seed) + edge_text(seed + 9, 300)
    mask = ud.lead_mask(np.frombuffer(data, np.uint8))
    at = ud.Offsets(coarse(ud.count_codepoints(as_tensor(data), prefixes=True), tile), data)
    starts = np.flatnonzero(mask)
    assert [at.byte_of(k) for k in range(starts.shape[0])] == starts.tolist()
    before = np.concatenate([[0], np.cumsum(mask)])
    assert [at.codepoints_before(b) for b in range(len(data) + 1)] == before.tolist()


def test_an_expected_count():
    """count_codepoints with the count the caller knows: equal, it passes
    (on the CPU `check` has nothing left to read); different, it raises."""
    data = as_tensor("ab ж\u00e9".encode() + b"\xe2")  # five codepoints, then a cut-off lead
    counted = ud.count_codepoints(data, expect=5)
    assert counted.n == 5 and ud.check(counted) is counted
    with pytest.raises(RuntimeError):
        ud.count_codepoints(data, expect=6)
    with pytest.raises(RuntimeError):
        ud.count_codepoints(data[:0], expect=1)


@pytest.mark.parametrize("cut", ["ascii", "lead", "u2581"])
def test_the_head_of_a_count(cut):
    """The count of a document's first bytes, up to a byte no sequence
    continues into, from the count of all of them: its bucket is the
    head's own decode."""
    sep = {"ascii": b" ", "lead": "中".encode(), "u2581": "▁".encode()}[cut]
    data = "ab ж\u00e9".encode() + b"\xe2\x82" + sep + "x 中".encode()
    at = data.index(sep, 7)
    want = check(data[:at])
    counted = ud.head(ud.count_codepoints(as_tensor(data)), at, want.shape[0])
    assert counted.n == want.shape[0] and counted.data.shape[0] == at
    np.testing.assert_array_equal(ud.write_codepoints(counted, 16).numpy()[: counted.n], want)
    assert not ud.write_codepoints(counted, 16).numpy()[counted.n :].any()


def test_the_wrappers_raise():
    t = as_tensor(b"abcd")
    for bad in (t.to(torch.int32), t.view(2, 2), t[::2], t.to(torch.int8)):
        with pytest.raises(ValueError):
            ud.count_codepoints(bad)
    with pytest.raises(ValueError):
        ud.write_codepoints(ud.count_codepoints(t), 3)


def test_the_cpu_launches_nothing():
    before = (ud.count_codepoints.launches, ud.write_codepoints.launches)
    ud.write_codepoints(ud.count_codepoints(as_tensor(b"abc")), 8)
    assert (ud.count_codepoints.launches, ud.write_codepoints.launches) == before


def bucket_encoder(monkeypatch):
    """A CPU FastEncoder whose encode_padded hands back the whole padded
    bucket it is given, so that a call returns its bucket: the features,
    probe and commit after it are the same code on both entries."""
    vocab = parse_vocab(make_vocab(make_corpus(20_000, seed=31), vocab_size=600, seed=31))
    monkeypatch.setattr(engine, "encode_padded",
                        lambda cp_pad, n, table, **st: (cp_pad, torch.tensor(cp_pad.shape[0])))
    return FastEncoder(vocab, device="cpu")


@pytest.mark.parametrize("path", GOLDEN, ids=[os.path.basename(p)[:-4] for p in GOLDEN])
def test_encode_bytes_bucket_equals_encode_codepoints_on_the_goldens(path, monkeypatch):
    z = np.load(path)
    data = make_corpus(int(z["corpus_bytes"]), lang=str(z["lang"]))
    enc = bucket_encoder(monkeypatch)
    got = enc.encode_bytes(data)
    np.testing.assert_array_equal(got, enc.encode_codepoints(uni.decode_utf8(data)))
    np.testing.assert_array_equal(
        got, pad_codepoints(uni.decode_utf8(data).astype(np.int32), enc.index.max_len))


@pytest.mark.parametrize("seed", range(3))
def test_encode_bytes_bucket_equals_encode_codepoints_on_invalid_utf8(seed, monkeypatch):
    """Text with edge bytes spliced in at random places."""
    rng = np.random.default_rng(seed)
    text = bytearray(make_corpus(50_000, lang=("en", "ru", "zh")[seed], seed=seed))
    for at in sorted(rng.integers(0, len(text), 500).tolist(), reverse=True):
        text[at:at] = bytes([EDGE[int(rng.integers(0, len(EDGE)))]])
    data = bytes(text)
    enc = bucket_encoder(monkeypatch)
    assert len(uni.decode_utf8(data)) < len(data.decode("utf-8", errors="replace"))
    np.testing.assert_array_equal(enc.encode_bytes(data),
                                  enc.encode_codepoints(uni.decode_utf8(data)))

"""The port's host layer against the JAX package's: length tables (the
system's "weights"), carrying them onto a device, the vocabulary model,
the UTF-8 codec and the native oracle on the reference goldens.  All
outputs are integers: every comparison is exact."""

import glob
import hashlib
import os

import numpy as np
import pytest
import torch

from wordpiece_tpu.bench.corpus import make_corpus as jax_make_corpus
from wordpiece_tpu.bench.corpus import make_vocab as jax_make_vocab
from wordpiece_tpu.core import length_tables as jax_lt
from wordpiece_tpu.core import unicode as jax_uni
from wordpiece_tpu.core.vocab import parse_vocab as jax_parse_vocab
from wordpiece_tpu.runtime import loader as jax_loader
from wordpiece_tpu_torch.bench.corpus import make_corpus, make_vocab, make_vocab_bert
from wordpiece_tpu_torch.core import length_tables as lt
from wordpiece_tpu_torch.core import unicode as uni
from wordpiece_tpu_torch.core.vocab import parse_vocab
from wordpiece_tpu_torch.runtime import loader

torch.set_num_threads(1)

GOLDEN = sorted(
    glob.glob(os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "golden_*.npz"))
)

_FIELDS = ("k1", "k2", "tid", "rows_off", "mult1", "mult2", "lane_salts", "max_len",
           "unk_token_id")


def _vocab_lines(kind):
    data = make_corpus(200_000)
    if kind == "bert":
        return make_vocab_bert(data)
    if kind == "v3000":
        return make_vocab(data, vocab_size=3000)
    return ["[UNK]", "a", "##a", "ab", "中", "х", "-", "▁x", "[CLS]", "!!"]


@pytest.mark.parametrize("kind", ["tiny", "v3000", "bert"])
def test_length_tables_equal_jax(kind):
    lines = _vocab_lines(kind)
    mine = lt.build_length_tables(parse_vocab(lines))
    ref = jax_lt.build_length_tables(jax_parse_vocab(lines))
    for f in _FIELDS:
        a, b = getattr(mine, f), getattr(ref, f)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        else:
            assert list(a) == list(b) if isinstance(a, (list, tuple)) else a == b, f


@pytest.mark.parametrize("source", ["jax", "port"])
def test_load_length_tables_accepts_both(source):
    lines = _vocab_lines("v3000")
    if source == "jax":
        host = jax_lt.build_length_tables(jax_parse_vocab(lines))
    else:
        host = lt.build_length_tables(parse_vocab(lines))
    dt = lt.load_length_tables(host, "cpu")
    for name in ("k1", "k2", "tid"):
        t = getattr(dt, name)
        assert t.dtype == torch.int32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), getattr(host, name))
    assert dt.packed.shape == host.k1.shape + (4,)
    np.testing.assert_array_equal(dt.packed[..., 0].numpy(), host.k1)
    np.testing.assert_array_equal(dt.packed[..., 1].numpy(), host.k2)
    np.testing.assert_array_equal(dt.packed[..., 2].numpy(), host.tid)
    assert not dt.packed[..., 3].any()
    assert dt.rows_off == tuple(host.rows_off)
    assert int(dt.slot_off[-1]) == dt.n_slots == int((host.tid >= 0).sum())
    assert [s & 0xFFFFFFFF for s in dt.lane_salts_t.tolist()] == list(host.lane_salts)
    assert dt.statics == dict(
        max_len=host.max_len, rows_off=tuple(host.rows_off), mult1=host.mult1,
        mult2=host.mult2, lane_salts=tuple(host.lane_salts), unk_id=host.unk_token_id,
    )


def test_vocab_model_equal_jax():
    lines = _vocab_lines("bert") + ["[weird]", "…", "x́", "##!"]
    a, b = parse_vocab(lines), jax_parse_vocab(lines)
    for f in ("flat", "offsets", "lengths", "is_prefix", "is_special", "is_malformed",
              "active"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert (a.size, a.max_len, a.unk_token_id) == (b.size, b.max_len, b.unk_token_id)


def test_utf8_codec_equal_jax():
    rng = np.random.default_rng(5)
    for n in (0, 1, 7, 5000):
        raw = bytes(rng.integers(0, 256, size=n, dtype=np.uint8))
        np.testing.assert_array_equal(uni.decode_utf8(raw), jax_uni.decode_utf8(raw))
        np.testing.assert_array_equal(
            uni.decode_utf8(raw, native=False), jax_uni.decode_utf8(raw, native=False)
        )


def test_corpus_generators_equal_jax():
    a = make_corpus(120_000, lang="ru")
    assert a == jax_make_corpus(120_000, lang="ru")
    assert make_vocab(a, vocab_size=1000) == jax_make_vocab(a, vocab_size=1000)


@pytest.mark.parametrize("path", GOLDEN, ids=os.path.basename)
def test_native_oracle_equal_jax_on_goldens(path):
    z = np.load(path)
    corpus = make_corpus(int(z["corpus_bytes"]), lang=str(z["lang"]))
    lines = make_vocab(corpus, vocab_size=int(z["vocab_size"]))
    assert hashlib.sha256(corpus).hexdigest() == str(z["corpus_sha"])
    assert hashlib.sha256("\n".join(lines).encode()).hexdigest() == str(z["vocab_sha"])
    mine = loader.VocabHandle(parse_vocab(lines)).encode(loader.decode_utf8(corpus))
    ref = jax_loader.VocabHandle(jax_parse_vocab(lines)).encode(jax_loader.decode_utf8(corpus))
    np.testing.assert_array_equal(mine, ref)
    np.testing.assert_array_equal(mine, z["ids"].astype(np.int32))

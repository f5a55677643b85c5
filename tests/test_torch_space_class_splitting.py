"""The port's chunking on corpora whose only separators are newlines or
U+2581 (plausible for zh/ja line corpora): the word engine's pipeline, the
linear engine's segmentation pieces and the multi-process file shards must
still split into many parts, cut at space-class codepoints (the reference
snaps its chunk boundaries at any space-class char: is_space covers 9..13,
32 and U+2581, src/third_party/utf8.cpp:10-12).  Mirrors
tests/test_space_class_splitting.py; ids are held against the native
oracle and the JAX package's word engine, exactly."""

import numpy as np
import pytest
import torch

from wordpiece_tpu.core.vocab import parse_vocab as jax_parse_vocab
from wordpiece_tpu.engine_word import WordEncoder as JaxWordEncoder
from wordpiece_tpu.parallel.multihost import file_shard_bounds as jax_file_shard_bounds
from wordpiece_tpu_torch.core.vocab import parse_vocab
from wordpiece_tpu_torch.engine_linear import LinearEncoder
from wordpiece_tpu_torch.engine_word import WordEncoder
from wordpiece_tpu_torch.parallel.multihost import file_shard_bounds
from wordpiece_tpu_torch.runtime import loader
from wordpiece_tpu_torch.utils.profiling import StageStats

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(not loader.available(), reason="native runtime required")

LINES = (
    ["[PAD]", "[UNK]", "the", "quick", "brown", "fox", "jump", "##s",
     "over", "lazy", "dog", "an", "and", "a"]
    + [c for c in "abcdefghijklmnopqrstuvwxyz"]
    + ["##" + c for c in "abcdefghijklmnopqrstuvwxyz"]
)


def corpus(sep: str) -> bytes:
    """4,000 seeded words of 1-11 letters joined by `sep` alone (the corpus
    of tests/test_space_class_splitting.py:59-70)."""
    rng = np.random.default_rng(3)
    words = [
        "".join(rng.choice(list("abcdefgh"), size=int(rng.integers(1, 12))))
        for _ in range(4000)
    ]
    data = sep.join(words).encode()
    assert b" " not in data
    return data


@pytest.fixture(scope="module")
def references():
    """Per separator: (corpus, native oracle ids, the JAX word engine's ids)."""
    out = {}
    for sep in ("\n", "▁"):
        data = corpus(sep)
        want = loader.VocabHandle(parse_vocab(LINES)).encode(loader.decode_utf8(data))
        out[sep] = (data, want, JaxWordEncoder(jax_parse_vocab(LINES)).encode_bytes(data))
    return out


@pytest.mark.parametrize("sep", ["\n", "▁"])
def test_word_pipeline_chunks_on_space_class_corpus(sep, references):
    data, want, jax_ids = references[sep]
    np.testing.assert_array_equal(jax_ids, want)
    enc = WordEncoder(parse_vocab(LINES), device="cpu")
    enc.PIPELINE_FIRST = 2000
    enc.PIPELINE_CHUNK = 5000
    enc.stats = StageStats()
    got = enc.encode_bytes(data)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_ids)
    # Many chunks, each near its target size (a 0x20-only cut would leave
    # one chunk of the whole corpus).
    chunks = enc.stats.calls["host_segment_dedupe"]
    assert chunks > 5
    assert enc.stats.bytes["host_segment_dedupe"] / chunks < 3 * enc.PIPELINE_CHUNK


@pytest.mark.parametrize("sep", ["\n", "▁"])
def test_linear_pieces_on_space_class_corpus(sep, references):
    data, want, jax_ids = references[sep]
    enc = LinearEncoder(parse_vocab(LINES), device="cpu")
    enc.LINEAR_SEG_CHUNK = 3000
    enc.LINEAR_BATCH_TARGET = 2000
    enc.stats = StageStats()
    got = enc.encode_bytes(data)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_ids)
    pieces = enc.stats.calls["host_segment_dedupe"]
    assert pieces > 5
    assert enc.stats.bytes["host_segment_dedupe"] / pieces < 3 * enc.LINEAR_SEG_CHUNK
    assert enc.stats.calls["device_dispatch"] > 1


def test_file_shard_bounds_newline_corpus(tmp_path):
    """The shards of tests/test_space_class_splitting.py:114-137: equal to
    the JAX package's bounds, balanced, cut at space-class codepoints."""
    words = [f"tok{i % 1331}" for i in range(30_000)]
    data = "\n".join(words).encode()
    assert b" " not in data
    p = tmp_path / "corpus.txt"
    p.write_bytes(data)
    n_procs = 4
    bounds = [file_shard_bounds(str(p), i, n_procs) for i in range(n_procs)]
    assert bounds == [jax_file_shard_bounds(str(p), i, n_procs) for i in range(n_procs)]
    assert bounds[0][0] == 0 and bounds[-1][1] == len(data)
    for (_, e0), (s1, _) in zip(bounds, bounds[1:]):
        assert e0 == s1
    target = len(data) / n_procs
    for s, e in bounds:
        assert 0.5 * target < (e - s) < 2 * target
    for s, _ in bounds[1:]:
        assert data[s] in (0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20) or data[s : s + 3] == b"\xe2\x96\x81"

"""The reference-scale differential stress (tests/test_stress_reference_scale.py)
through the port's engines on the CPU.

The port's copies of the JAX test's generators
(wordpiece_tpu_torch/bench/stress_cases.py) are held to the JAX test
module's functions, character for character, on the same seeds.  Then the
port's fast, linear and fast-stream engines (device="cpu": the kernels'
plain versions) encode each regime, positive and negative, against the
native oracle; on regime 2 at 1,000,000 chars and regime 1 at 300,000
their fast and linear ids also equal the JAX package's.  The fast-stream
engine's plain probe loops to max_len at every position, so its
single-unit case is cut to 100,000 chars and 3,000 parts.  Ids are
integers: exact."""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

from wordpiece_tpu_torch import api
from wordpiece_tpu_torch.bench import stress_cases as sc
from wordpiece_tpu_torch.core import unicode as uni
from wordpiece_tpu_torch.core.vocab import parse_vocab
from wordpiece_tpu_torch.runtime import loader

torch.set_num_threads(1)

if not loader.available():  # pragma: no cover
    pytest.skip("native runtime required for the oracle", allow_module_level=True)

JAX_TEST = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "test_stress_reference_scale.py")
SIGNS = ["positive", "negative"]


def jax_generators():
    """The JAX test module, loaded from its file under a name of its own."""
    spec = importlib.util.spec_from_file_location("_jax_stress_generators", JAX_TEST)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [sc.SEED, 3])
def test_generators_equal_jax(seed):
    """random_string, random_split and spaced_corpus_and_vocab draw the
    same text and vocabulary as the JAX test's, from the same generator
    state, at sizes that run the spaced text over several lines."""
    ref = jax_generators()
    mine, theirs = np.random.default_rng(seed), np.random.default_rng(seed)
    s = sc.random_string(mine, 20_000)
    assert s == ref._random_string(theirs, 20_000) and len(s) == 20_000
    assert sc.random_split(s, mine, 700) == ref._random_split(s, theirs, 700)
    text, lines = sc.spaced_corpus_and_vocab(mine, 100_000)
    assert (text, lines) == ref._spaced_corpus_and_vocab(theirs, 100_000)
    assert mine.bit_generator.state == theirs.bit_generator.state


def test_cases_equal_jax_test_inputs():
    """single_unit, spaced and mid_scale give the JAX test's inputs: the
    seed, the draws in its order, its negative vocabularies."""
    ref = jax_generators()
    rng = np.random.default_rng(17)
    s = ref._random_string(rng, 30_000)
    split = ref._random_split(s, rng, 1_000)
    assert sc.single_unit(30_000, 1_000) == (s.encode(), split, split[1:])
    text, lines = ref._spaced_corpus_and_vocab(np.random.default_rng(17), 50_000)
    negative = list(lines)
    for i, ln in enumerate(negative):
        if ln.startswith("##") and len(ln) == 3:
            del negative[i]
            break
    assert len(negative) == len(lines) - 1
    assert sc.spaced(50_000) == (text.encode(), lines, negative)
    rng = np.random.default_rng(17)
    for text_len, data, pos, neg in sc.mid_scale((2_000, 5_000)):
        s = ref._random_string(rng, text_len)
        split = ref._random_split(s, rng, min(30_000, text_len // 10))
        assert (data, pos, neg) == (s.encode(), split, split[1:])


@functools.lru_cache(maxsize=None)
def case(name: str):
    """(text bytes, {sign: (lines, vocab, oracle ids)}) of a named case."""
    if name == "single_unit_300k":
        data, pos, neg = sc.single_unit(300_000, 10_000)
    elif name == "single_unit_100k":
        data, pos, neg = sc.single_unit(100_000, 3_000)
    elif name == "spaced_1M":
        data, pos, neg = sc.spaced(1_000_000)
    else:
        text_len = int(name.removeprefix("mid_"))
        data, pos, neg = next((d, p, n) for t, d, p, n in sc.mid_scale() if t == text_len)
    cps = uni.decode_utf8(data)
    out = {}
    for sign, lines in zip(SIGNS, (pos, neg)):
        vocab = parse_vocab(lines)
        assert vocab.unk_token_id == -1  # no [UNK] line in split vocabs
        out[sign] = (lines, vocab, loader.VocabHandle(vocab).encode(cps))
    return data, out


def encode(name: str, sign: str, engine: str) -> np.ndarray:
    data, signs = case(name)
    lines, vocab, want = signs[sign]
    got = api._encode_with(api.make_encoder(vocab, engine, device="cpu"), data)
    assert want.shape[0] > 0
    assert got.dtype == np.int32 and np.array_equal(got, want), f"{engine} {name} {sign}"
    return got


def jax_ids(name: str, sign: str, engine: str) -> np.ndarray:
    from wordpiece_tpu.api import make_encoder
    from wordpiece_tpu.core.vocab import parse_vocab as jax_parse_vocab
    from wordpiece_tpu.engine_linear import LinearEncoder

    data, signs = case(name)
    vocab = jax_parse_vocab(signs[sign][0])
    enc = make_encoder(vocab, engine="fast") if engine == "fast" else LinearEncoder(vocab)
    return np.asarray(enc.encode_bytes(data))


@pytest.mark.parametrize("sign", SIGNS)
@pytest.mark.parametrize("engine", ["fast", "linear"])
def test_single_unit_equals_oracle_and_jax(engine, sign):
    """Regime 1 at 300,000 chars and 10,000 parts: one unit, which the
    fast engine sends to its overflow route and the linear engine (max_len
    past MAX_SLOT_LEN) to its scalar route."""
    from wordpiece_tpu_torch.engine_linear import LinearEncoder

    assert case("single_unit_300k")[1][sign][1].max_len > LinearEncoder.MAX_SLOT_LEN
    got = encode("single_unit_300k", sign, engine)
    np.testing.assert_array_equal(got, jax_ids("single_unit_300k", sign, engine))


@pytest.mark.parametrize("sign", SIGNS)
def test_single_unit_fast_stream(sign):
    """Regime 1 at 100,000 chars and 3,000 parts through the fast-stream
    engine: the features, probe and commit over one unit, the probe past
    32 lengths (its ascending pass), the commit's walk one chain long."""
    assert case("single_unit_100k")[1][sign][1].max_len > 32
    encode("single_unit_100k", sign, "fast-stream")


@pytest.mark.parametrize("sign", SIGNS)
@pytest.mark.parametrize("engine", ["fast", "fast-stream", "linear"])
def test_spaced_equals_oracle(engine, sign):
    """Regime 2 at 1,000,000 chars: Zipf words, a >= 25,000-piece vocab
    with max_len <= 16 (the linear engine's device batch), UNK-heavy when
    negative; fast and linear also equal the JAX package's ids."""
    from wordpiece_tpu_torch.engine_linear import LinearEncoder

    lines, vocab, _ = case("spaced_1M")[1][sign]
    assert len(lines) >= 25_000 - (sign == "negative")
    assert vocab.max_len <= LinearEncoder.MAX_SLOT_LEN
    got = encode("spaced_1M", sign, engine)
    if engine != "fast-stream":
        np.testing.assert_array_equal(got, jax_ids("spaced_1M", sign, engine))


@pytest.mark.parametrize("sign", SIGNS)
@pytest.mark.parametrize("name,engine", [("mid_100000", "fast"), ("mid_500000", "fast"),
                                         ("mid_100000", "fast-stream")])
def test_mid_scale_equals_oracle(name, engine, sign):
    """The reference's 100,000 and 500,000-char sweep at its own parts
    count (min(30,000, len // 10)); fast-stream at 100,000."""
    encode(name, sign, engine)

"""The native session's N-part scan (`wp_dedupe_session_segment`).

For any `n_threads`, a session over three successive chunks returns what
the one-part session returns, array for array, and runs the parts the cut
rule gives: min(n_threads, size / 512 KiB) parts, cut k at the first
space-class byte at or after k * size / parts, a cut that passes the next
target merging two parts.  Then the engines' thread counts: the linear
engine segments with the wide count (`loader.wide_n_threads`) and equals
the JAX package's linear engine; the word engine keeps `loader.n_threads()`;
`set_n_threads` and `WORDPIECE_TPU_THREADS` override both.
"""

import numpy as np
import pytest
import torch

from wordpiece_tpu import engine_linear as jel
from wordpiece_tpu.core.vocab import parse_vocab as jax_parse_vocab
from wordpiece_tpu_torch.bench.corpus import make_corpus, make_vocab
from wordpiece_tpu_torch.core.vocab import parse_vocab
from wordpiece_tpu_torch.engine_linear import LinearEncoder
from wordpiece_tpu_torch.engine_word import WordEncoder
from wordpiece_tpu_torch.runtime import loader
from wordpiece_tpu_torch.utils.profiling import StageStats

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(not loader.available(), reason="native runtime required")

# Up to 5, 2 and 1 parts: the engine's 3 MB piece, a smaller one, and one
# under the 512 KiB a part needs.
CHUNK_SIZES = (3_000_000, 1_200_000, 300_000)
THREADS = (1, 2, 3, 4, 5, 7, 8)
U2581 = "▁".encode()


def space_cuts(data: bytes) -> np.ndarray:
    """Offsets of the space-class bytes the library may cut at: ASCII
    whitespace (9-13, 32) and the lead byte of U+2581."""
    b = np.frombuffer(data, np.uint8)
    cut = (b == 0x20) | ((b >= 9) & (b <= 13))
    cut[:-2] |= (b[:-2] == 0xE2) & (b[1:-1] == 0x96) & (b[2:] == 0x81)
    return np.flatnonzero(cut)


def cut_rule(data: bytes, n_threads: int) -> int:
    """The parts the library runs on `data` at `n_threads`."""
    size = len(data)
    want = max(1, min(n_threads, size // (512 << 10)))
    cuts = space_cuts(data)
    bounds = [0]
    for k in range(1, want):
        target = k * size // want
        if target <= bounds[-1]:
            continue  # the last cut passed this target: the parts merge
        i = int(np.searchsorted(cuts, target))
        if i == cuts.shape[0]:
            break
        bounds.append(int(cuts[i]))
    return len(bounds)


def words(rng, n_types: int = 20_000) -> list[bytes]:
    letters = np.frombuffer(b"etaoinshrdlcumwfgypbvkjxqz", np.uint8)
    lens = rng.integers(1, 13, size=n_types)
    flat = letters[rng.integers(0, 26, size=int(lens.sum()))].tobytes()
    offs = np.concatenate([[0], np.cumsum(lens)])
    return [flat[offs[i] : offs[i + 1]] for i in range(n_types)]


def zipf_text(rng, sep: bytes, size: int) -> bytes:
    """Word types ranked by a Zipf law (1/rank), joined by `sep` alone."""
    types = words(rng)
    p = 1.0 / np.arange(1, len(types) + 1)
    n = size // 4
    draws = rng.choice(len(types), size=n, p=p / p.sum())
    out = sep.join(types[i] for i in draws)
    assert len(out) >= size
    return out[:size]


def cjk_text(rng, size: int) -> bytes:
    """Kanji (3,000 of them, Zipf-ranked), kana, U+3002 and U+2014 in
    lines of 20-120 codepoints: no 0x20, newlines the only space class."""
    kanji = 0x4E00 + rng.permutation(3000)
    p = 1.0 / np.arange(1, 3001)
    n = size // 3 + size // 50
    cps = kanji[rng.choice(3000, size=n, p=p / p.sum())]
    kana = rng.random(n) < 0.2
    cps[kana] = 0x3041 + rng.integers(0, 86, size=int(kana.sum()))
    cps[rng.random(n) < 0.03] = 0x3002
    cps[rng.random(n) < 0.01] = 0x2014
    line_ends = np.cumsum(rng.integers(20, 121, size=n // 20))
    cps[line_ends[line_ends < n]] = 0x0A
    out = "".join(map(chr, cps.tolist())).encode()
    assert b" " not in out and len(out) >= size
    return out[:size]


def straddle_text(rng, size: int) -> bytes:
    """Space-separated text with one 610 KB unit over bytes 1,795,000 to
    2,405,000: in a 3 MB chunk it holds the cut of every split from two
    parts up, and at five parts it spans two targets (1.8 and 2.4 MB), so
    two parts merge."""
    text = zipf_text(rng, b" ", size)
    lo, hi = 1_795_000, 2_405_000
    return text[:lo] + b" " + b"q" * (hi - lo - 2) + b" " + text[hi:]


CORPORA = {
    "zipf_spaces": lambda rng, n: zipf_text(rng, b" ", n),
    "newlines": lambda rng, n: zipf_text(rng, b"\n", n),
    "u2581": lambda rng, n: zipf_text(rng, U2581, n),
    "cjk_dense": cjk_text,
    "straddle_600KB": straddle_text,
}

_REFS: dict = {}


def run_session(chunks, n_threads: int):
    """-> per chunk (occ, new_start, new_len, new_cplen, n_total, parts,
    pending) through one session."""
    s = loader.DedupeSession()
    try:
        out = []
        for c in chunks:
            arrays = s.segment(c, threads=n_threads)
            out.append((*arrays, s.n_total, s.last_parts, s.last_pending))
        return out
    finally:
        s.close()


def reference(name: str):
    """(chunks, the one-part session's outputs), made once per corpus."""
    if name not in _REFS:
        rng = np.random.default_rng(sorted(CORPORA).index(name) + 24)
        text = CORPORA[name](rng, sum(CHUNK_SIZES))
        bounds = np.cumsum((0,) + CHUNK_SIZES)
        chunks = [text[bounds[i] : bounds[i + 1]] for i in range(len(CHUNK_SIZES))]
        _REFS[name] = (chunks, run_session(chunks, 1))
    return _REFS[name]


@pytest.mark.parametrize("n_threads", THREADS)
@pytest.mark.parametrize("name", sorted(CORPORA))
def test_parts_equal_one_part(name, n_threads):
    chunks, want = reference(name)
    got = run_session(chunks, n_threads)
    for i, (g, w, chunk) in enumerate(zip(got, want, chunks)):
        for key, a, b in zip(("occ", "new_start", "new_len", "new_cplen"), g[:4], w[:4]):
            np.testing.assert_array_equal(a, b, err_msg=f"chunk {i} {key}")
        assert g[4] == w[4], f"chunk {i} n_total"
        assert g[5] == cut_rule(chunk, n_threads), f"chunk {i} parts"
        # One part's pendings are its new units; more parts find some
        # units in two parts and merge them twice.
        n_new = g[1].shape[0]
        assert g[6] == n_new if g[5] == 1 else g[6] >= n_new
    assert want[0][0].shape[0] > 100_000 and want[1][1].shape[0] > 0


def test_the_cut_rule_on_known_chunks():
    """The counts the rule gives where they can be read off the text: the
    3 MB spaced chunk runs min(n, 5) parts; with the 610 KB unit over two
    targets it runs 4 from five threads up; a chunk under 512 KiB runs 1."""
    spaced, _ = reference("zipf_spaces")
    straddle, _ = reference("straddle_600KB")
    assert [cut_rule(spaced[0], n) for n in THREADS] == [1, 2, 3, 4, 5, 5, 5]
    assert [cut_rule(straddle[0], n) for n in THREADS] == [1, 2, 3, 4, 4, 4, 4]
    assert [cut_rule(spaced[1], n) for n in THREADS] == [1, 2, 2, 2, 2, 2, 2]
    assert {cut_rule(spaced[2], n) for n in THREADS} == {1}


# -- the engines' thread counts ------------------------------------------------


@pytest.fixture(scope="module")
def text_and_ids():
    """A ~2.5 MB text, its vocab lines and the JAX package's linear ids."""
    data = make_corpus(2_500_000)
    lines = make_vocab(data, vocab_size=3000)
    want = np.asarray(jel.LinearEncoder(jax_parse_vocab(lines)).encode_bytes(data))
    return data, lines, want


@pytest.fixture
def eight_cores(monkeypatch):
    """A host of 8 usable cores and no user override: the wide count is 6."""
    monkeypatch.setattr(loader.os, "sched_getaffinity", lambda pid: set(range(8)))
    monkeypatch.delenv("WORDPIECE_TPU_THREADS", raising=False)
    loader.set_n_threads(None)
    yield
    loader.set_n_threads(None)


@pytest.fixture
def segment_calls(monkeypatch):
    """Every DedupeSession.segment call: (threads passed, parts run)."""
    calls = []
    segment = loader.DedupeSession.segment

    def recorded(self, data, threads=None):
        out = segment(self, data, threads=threads)
        calls.append((threads, self.last_parts))
        return out

    monkeypatch.setattr(loader.DedupeSession, "segment", recorded)
    return calls


def linear_parts(lines, data):
    enc = LinearEncoder(parse_vocab(lines), device="cpu")
    enc.stats = StageStats()
    ids = enc.encode_bytes(data)
    return ids, enc.stats.report()["counters"]


def word_ids(lines, data):
    """The word engine's ids: 2.5 MB is one chunk (under PIPELINE_CHUNK)."""
    return WordEncoder(parse_vocab(lines), device="cpu").encode_bytes(data)


@pytest.mark.parametrize("cores,wide", [(1, 1), (2, 1), (3, 1), (4, 2), (8, 6), (64, 62)])
def test_wide_n_threads_leaves_two_cores(monkeypatch, cores, wide):
    monkeypatch.setattr(loader.os, "sched_getaffinity", lambda pid: set(range(cores)))
    monkeypatch.delenv("WORDPIECE_TPU_THREADS", raising=False)
    assert loader.wide_n_threads() == wide


def test_linear_wide_split_equals_jax_linear(text_and_ids, eight_cores, segment_calls):
    """One 2.5 MB piece at the wide count (6 threads): the parts the cut
    rule gives (4), counted in `segment_parts`; the ids equal the JAX
    package's linear engine's."""
    data, lines, want = text_and_ids
    ids, counters = linear_parts(lines, data)
    np.testing.assert_array_equal(ids, want)
    assert segment_calls == [(6, 4)] and cut_rule(data, 6) == 4
    assert counters["segment_parts"] == 4
    assert counters["segment_pending"] >= counters["units_new"] > 10_000


def test_word_engine_keeps_n_threads(text_and_ids, eight_cores, segment_calls):
    """The word engine leaves the count to `n_threads()`: two parts by
    default, on a host where the wide count would be 6."""
    data, lines, want = text_and_ids
    np.testing.assert_array_equal(word_ids(lines, data), want)
    assert loader.n_threads() == 2
    assert segment_calls == [(None, 2)]


@pytest.mark.parametrize("how", ["set_n_threads", "env"])
def test_the_user_count_overrides_both_engines(
    text_and_ids, eight_cores, segment_calls, monkeypatch, how
):
    data, lines, want = text_and_ids
    if how == "env":
        monkeypatch.setenv("WORDPIECE_TPU_THREADS", "3")
    else:
        loader.set_n_threads(3)
    assert loader.n_threads() == loader.wide_n_threads() == 3
    ids, counters = linear_parts(lines, data)
    np.testing.assert_array_equal(ids, want)
    assert counters["segment_parts"] == 3
    np.testing.assert_array_equal(word_ids(lines, data), want)
    assert segment_calls == [(3, 3), (None, 3)]

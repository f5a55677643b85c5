"""The word match+commit kernel's plain PyTorch version and its wrappers'
CPU path, against the JAX package's word_match_commit and its Pallas
compact program (interpret mode).  All outputs are integers: exact.

The CUDA kernel itself is held against the plain version on the card by
chip_smoke.py, on the same kinds of unit matrices (chip_smoke's
unit_matrices generator, at a smaller row count here)."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wordpiece_tpu.core.length_tables import build_length_tables as jax_build_tables
from wordpiece_tpu.core.vocab import parse_vocab as jax_parse_vocab
from wordpiece_tpu.engine_word import BLOCK_ROWS, pack_groups
from wordpiece_tpu.ops.word_kernel import word_match_commit as jax_wmc
from wordpiece_tpu.ops.word_kernel_pallas import word_match_commit_compact as jax_compact
from wordpiece_tpu_torch.bench.corpus import make_corpus, make_vocab, make_vocab_bert
from wordpiece_tpu_torch.core.length_tables import load_length_tables
from wordpiece_tpu_torch.engine_word import STRIDES, WIDTHS, _narrow
from wordpiece_tpu_torch.ops import word_kernel_cuda as wk
from wordpiece_tpu_torch.ops.word_kernel import _mul32, word_match_commit

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import unit_matrices  # noqa: E402

torch.set_num_threads(1)

KINDS = ("ascii", "multilingual", "astral", "unk_heavy", "empty_rows")
_STATE: dict = {}


def _setup():
    """Bert-shaped vocab tables (built by the JAX package, carried over
    with load_length_tables) and the unit matrices of every width."""
    if not _STATE:
        data = make_corpus(200_000)
        lines = make_vocab_bert(data)
        host = jax_build_tables(jax_parse_vocab(lines))
        words = data.decode("utf-8", errors="ignore").split()
        rng = np.random.default_rng(2024)
        _STATE["host"] = host
        _STATE["tables"] = load_length_tables(host, "cpu")
        _STATE["mats"] = {w: unit_matrices(w, words, rng, n=48) for w in WIDTHS}
    return _STATE["host"], _STATE["tables"], _STATE["mats"]


def _statics(host):
    return dict(
        max_len=host.max_len, rows_off=tuple(host.rows_off), mult1=host.mult1,
        mult2=host.mult2, lane_salts=tuple(host.lane_salts), unk_id=host.unk_token_id,
    )


def _jax_emit(mat, host, width):
    pad = np.full((mat.shape[0], width + host.max_len), 32, np.int32)
    pad[:, :width] = mat
    out = jax_wmc(
        jnp.asarray(pad), jnp.asarray(host.k1), jnp.asarray(host.k2), jnp.asarray(host.tid),
        width=width, **_statics(host),
    )
    return np.asarray(out)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("width", WIDTHS)
def test_plain_equals_jax(width, kind):
    host, tables, mats = _setup()
    mat = mats[width][kind]
    want = _jax_emit(mat, host, width)
    got = word_match_commit(
        torch.from_numpy(_narrow(mat)), tables.k1, tables.k2, tables.tid, width=width,
        **tables.statics,
    )
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if kind != "empty_rows":
        assert (want != -2).any()


def test_plain_takes_any_dtype_and_pad_columns():
    """The narrow uint8/uint16 layout, int32, and the JAX package's padded
    int32 layout give the same emits; columns >= width read as space."""
    host, tables, mats = _setup()
    mat = mats[15]["ascii"]
    base = word_match_commit(
        torch.from_numpy(mat), tables.k1, tables.k2, tables.tid, width=15, **tables.statics
    )
    for arr in (mat.astype(np.uint8), mat.astype(np.uint16)):
        got = word_match_commit(
            torch.from_numpy(arr), tables.k1, tables.k2, tables.tid, width=15,
            **tables.statics,
        )
        assert torch.equal(got, base)
    wide = np.full((mat.shape[0], 15 + 9), ord("a"), np.int32)
    wide[:, :15] = mat
    got = word_match_commit(
        torch.from_numpy(wide), tables.k1, tables.k2, tables.tid, width=15, **tables.statics
    )
    assert torch.equal(got, base)


def test_mul32_wraps_like_uint32():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 1 << 32, size=1000, dtype=np.uint64).astype(np.uint32)
    a[:3] = [0, 1, 0xFFFFFFFF]
    for m in (1, 0x9E3779B1, 0xFFFFFFFF, 0x10001):
        with np.errstate(over="ignore"):
            want = a * np.uint32(m)
        got = _mul32(torch.from_numpy(a.astype(np.int64)), m)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def _jax_compact_emits(mats, strides, host, cap):
    """The JAX package's compact program (Pallas, interpret mode), decoded
    as its engine decodes it, into per-bucket [U, W] emit matrices."""
    packed = [pack_groups(m, s, host.max_len) for m, s in zip(mats, strides)]
    fused = np.asarray(
        jax_compact(
            tuple(jnp.asarray(p) for p in packed), jnp.asarray(host.k1),
            jnp.asarray(host.k2), jnp.asarray(host.tid), strides=strides,
            block_rows=BLOCK_ROWS, cap=cap, interpret=True, **_statics(host),
        )
    )
    rows = [p.shape[0] for p in packed]
    total = int(fused[0])
    assert total <= cap
    counts = fused[1 : 1 + sum(rows)].astype(np.int64)
    compact = fused[1 + sum(rows) : 1 + sum(rows) + total]
    tid, lane = (compact >> 7) - 2, compact & 127
    row_of_id = np.repeat(np.arange(counts.shape[0]), counts)
    out, row0, lo = [], 0, 0
    for m, s, nrows in zip(mats, strides, rows):
        hi = lo + int(counts[row0 : row0 + nrows].sum())
        emit = np.full((nrows * (128 // s), s - 1), -2, np.int32)
        r = row_of_id[lo:hi] - row0
        emit[r * (128 // s) + lane[lo:hi] // s, lane[lo:hi] % s] = tid[lo:hi]
        out.append(emit[: m.shape[0]])
        row0, lo = row0 + nrows, hi
    return out


def test_compact_wrapper_cpu_equals_jax_compact():
    """One small case: two buckets (widths 7 and 15) and a 600-token vocab
    keep the interpreted Pallas program quick to compile and run."""
    _, _, mats = _setup()
    data = make_corpus(200_000)
    host = jax_build_tables(jax_parse_vocab(make_vocab(data, vocab_size=600)))
    tables = load_length_tables(host, "cpu")
    small = [mats[7]["ascii"][:24], mats[15]["multilingual"][:24]]
    cap = 1 << 13
    want = _jax_compact_emits(small, STRIDES[:2], host, cap)
    before = wk.word_match_commit_bucket.launches
    cps = [torch.from_numpy(_narrow(m)) for m in small]
    fused, emits = wk.word_match_commit_compact(cps, tables, cap=cap)
    assert wk.word_match_commit_bucket.launches == before  # CPU: plain version
    assert fused.dtype == torch.int32 and fused.shape == (1 + 48 + cap,)
    got = wk.decode_compact(fused.numpy(), [m.shape for m in small], cap)
    for g, e, w in zip(got, emits, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(e.numpy(), w)
    assert all((w != -2).any() for w in want)


def test_compact_overflow_is_detected():
    _, tables, mats = _setup()
    cps = [torch.from_numpy(_narrow(mats[w]["ascii"])) for w in (7, 31)]
    emits = wk.word_match_commit_multi(cps, tables)
    n_ids = sum(int((e != -2).sum()) for e in emits)
    full = wk.compact_emits(emits, cap=n_ids).numpy()
    decoded = wk.decode_compact(full, [e.shape for e in emits], n_ids)
    for d, e in zip(decoded, emits):
        np.testing.assert_array_equal(d, e.numpy())
    short = wk.compact_emits(emits, cap=n_ids - 1).numpy()
    assert int(short[0]) == n_ids  # the true total, beyond the cap
    np.testing.assert_array_equal(short[1 : 1 + 96], full[1 : 1 + 96])  # counts intact
    assert wk.decode_compact(short, [e.shape for e in emits], n_ids - 1) is None


def test_wrapper_checks_devices_and_shapes():
    _, tables, mats = _setup()
    with pytest.raises(ValueError):
        wk.word_match_commit_bucket(torch.zeros(4, dtype=torch.int32), tables)
    meta = torch.zeros((2, 7), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        wk.word_match_commit_bucket(meta, tables)
    empty = wk.word_match_commit_bucket(torch.zeros((0, 7), dtype=torch.uint8), tables)
    assert empty.shape == (0, 7) and empty.dtype == torch.int32

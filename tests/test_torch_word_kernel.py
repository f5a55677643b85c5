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
from wordpiece_tpu_torch.ops.word_kernel import (
    _features, _mul32, _widen, probe_keys, walk_visited, word_match, word_match_commit,
)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import kernel_bytes_ops, unit_matrices  # noqa: E402

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


@pytest.mark.parametrize("width", WIDTHS)
def test_probe_keys_and_walk_find_the_emitted_slots(width):
    """Every position that emits a matched id is one the walk visits, and
    its token's slot lies in the (length, lane) list that probe_keys names,
    under the keys it computes: what chip_smoke's bound counts."""
    _, tables, mats = _setup()
    kw = {k: v for k, v in tables.statics.items() if k != "unk_id"}
    off = tables.slot_off.long()
    for kind in KINDS:
        cp = torch.from_numpy(_narrow(mats[width][kind]))
        wide = _widen(cp, width, tables.max_len)
        pos, space, _, wp, window = _features(wide, width, tables.max_len)
        best_id, best_len = word_match(cp, tables.k1, tables.k2, tables.tid, width=width, **kw)
        visited = walk_visited(pos, space, wp, window, best_len)
        emit = word_match_commit(cp, tables.k1, tables.k2, tables.tid, width=width,
                                 **tables.statics)
        assert not ((emit != -2) & ~visited).any()
        found = torch.zeros_like(visited)
        for l, h1, key2, lane, in_window in probe_keys(wide, wp, window, width=width, **kw):
            for u, j in (in_window & (best_len == l)).nonzero().tolist():
                s0, s1 = int(off[l * 128 + lane[u, j]]), int(off[l * 128 + lane[u, j] + 1])
                hits = [s for s in range(s0, s1)
                        if int(tables.slot_k1[s]) & 0xFFFFFFFF == int(h1[u, j])
                        and int(tables.slot_k2[s]) & 0xFFFFFFFF == int(key2[u, j])]
                assert hits and int(tables.slot_tid[hits[-1]]) == int(best_id[u, j])
                found[u, j] = True
        assert torch.equal(found, best_len > 0)
        nbytes, ops = kernel_bytes_ops([cp], tables)
        u = cp.shape[0]
        assert nbytes == (tables.slot_off.numel() * 4 + tables.n_slots * 12
                          + tables.lane_salts_t.numel() * 4
                          + cp.numel() * cp.element_size() + u * width * 4 + u * 4)
        # At least the hash work of one length per visited position.
        assert ops >= 12 * int((visited & ~space).sum())


def test_mul32_wraps_like_uint32():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 1 << 32, size=1000, dtype=np.uint64).astype(np.uint32)
    a[:3] = [0, 1, 0xFFFFFFFF]
    for m in (1, 0x9E3779B1, 0xFFFFFFFF, 0x10001):
        with np.errstate(over="ignore"):
            want = a * np.uint32(m)
        got = _mul32(torch.from_numpy(a.astype(np.int64)), m)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def _jax_compact(mats, strides, host, cap):
    """The JAX package's compact program (Pallas, interpret mode) on the
    same buckets: (its fused vector, packed rows per bucket)."""
    packed = [pack_groups(m, s, host.max_len) for m, s in zip(mats, strides)]
    fused = np.asarray(
        jax_compact(
            tuple(jnp.asarray(p) for p in packed), jnp.asarray(host.k1),
            jnp.asarray(host.k2), jnp.asarray(host.tid), strides=strides,
            block_rows=BLOCK_ROWS, cap=cap, interpret=True, **_statics(host),
        )
    )
    return fused, [p.shape[0] for p in packed]


def _jax_compact_emits(mats, strides, host, cap):
    """The JAX compact program decoded as its engine decodes it, into
    per-bucket [U, W] emit matrices."""
    fused, rows = _jax_compact(mats, strides, host, cap)
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


def _assert_compact_equals_jax(got, mats, strides, host, cap):
    """The port's compact vector against the JAX program's, entry for
    entry.  The JAX vector counts per packed row of 128 / stride units
    and codes (tid + 2) * 128 + lane with lane = unit-in-row * stride +
    position; the port counts per unit and codes the position alone.
    Both list the entries in (bucket, unit, position) order and keep the
    first `cap` of them."""
    want, rows = _jax_compact(mats, strides, host, cap)
    n = sum(m.shape[0] for m in mats)
    assert got.shape == (1 + n + cap,)
    total = int(want[0])
    assert int(got[0]) == total
    counts = got[1 : 1 + n]
    row_counts, base = [], 0
    for m, s, nrows in zip(mats, strides, rows):
        per_row = np.zeros(nrows * (128 // s), np.int64)
        per_row[: m.shape[0]] = counts[base : base + m.shape[0]]
        row_counts.append(per_row.reshape(nrows, 128 // s).sum(axis=1))
        base += m.shape[0]
    np.testing.assert_array_equal(np.concatenate(row_counts), want[1 : 1 + sum(rows)])
    kept = min(total, cap)
    entries = want[1 + sum(rows) : 1 + sum(rows) + kept].astype(np.int64)
    # The bucket of every JAX entry, from its rows' counts.
    bucket_end = np.cumsum([want[1 + r0 : 1 + r0 + r].sum() for r0, r in
                            zip(np.cumsum([0] + rows[:-1]), rows)])
    stride = np.asarray(strides)[np.searchsorted(bucket_end, np.arange(kept), side="right")]
    mapped = (entries >> 7) * 128 + (entries & 127) % stride
    np.testing.assert_array_equal(got[1 + n : 1 + n + kept], mapped)


def _compact_case():
    """Two buckets (widths 7 and 15) and a 600-token vocab keep the
    interpreted Pallas program quick to compile and run."""
    _, _, mats = _setup()
    data = make_corpus(200_000)
    host = jax_build_tables(jax_parse_vocab(make_vocab(data, vocab_size=600)))
    small = [mats[7]["ascii"][:24], mats[15]["multilingual"][:24]]
    return host, load_length_tables(host, "cpu"), small


def _launch_counts():
    return (wk.word_match_commit_multi.launches, wk.word_match_commit_multi.launches_global,
            wk.compact_from_counts.launches)


def test_compact_wrapper_cpu_equals_jax_compact():
    host, tables, small = _compact_case()
    cap = 1 << 13
    want = _jax_compact_emits(small, STRIDES[:2], host, cap)
    before = _launch_counts()
    cps = [torch.from_numpy(_narrow(m)) for m in small]
    fused, emits = wk.word_match_commit_compact(cps, tables, cap=cap)
    assert _launch_counts() == before  # CPU: plain versions
    assert fused.dtype == torch.int32 and fused.shape == (1 + 48 + cap,)
    got = wk.decode_compact(fused.numpy(), [m.shape for m in small], cap)
    for g, e, w in zip(got, emits, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(e.numpy(), w)
    assert all((w != -2).any() for w in want)
    _assert_compact_equals_jax(fused.numpy(), small, STRIDES[:2], host, cap)


def test_compact_overflow_cpu_equals_jax_compact():
    """A cap below the total: both programs report the true total, the
    counts stay whole, and the first `cap` entries agree."""
    host, tables, small = _compact_case()
    cps = [torch.from_numpy(_narrow(m)) for m in small]
    full, _ = wk.word_match_commit_compact(cps, tables, cap=1 << 13)
    total = int(full[0])
    cap = total // 3
    fused, _ = wk.word_match_commit_compact(cps, tables, cap=cap)
    assert int(fused[0]) == total > cap
    assert wk.decode_compact(fused.numpy(), [m.shape for m in small], cap) is None
    _assert_compact_equals_jax(fused.numpy(), small, STRIDES[:2], host, cap)


def _mixed_buckets():
    """Widths 7/15/31/127 as uint8/uint16/int32/uint8 and an empty
    width-15 bucket: the dtypes one dispatch can carry."""
    _, _, mats = _setup()
    chosen = [(mats[7]["ascii"], np.uint8), (mats[15]["multilingual"], np.uint16),
              (mats[31]["astral"], np.int32), (np.zeros((0, 15), np.int32), np.uint8),
              (mats[127]["empty_rows"], np.uint8)]
    cps = []
    for mat, dtype in chosen:
        assert np.array_equal(mat.astype(dtype).astype(np.int64), mat)
        cps.append(torch.from_numpy(mat.astype(dtype)))
    return cps


def test_dispatch_wrapper_cpu_mixed_dtypes_equals_plain():
    """One dispatch over buckets of mixed dtypes and an empty bucket gives
    each bucket's plain emits and their per-unit counts."""
    _, tables, _ = _setup()
    cps = _mixed_buckets()
    n = sum(int(cp.shape[0]) for cp in cps)
    counts = torch.full((n,), -7, dtype=torch.int32)
    before = _launch_counts()
    emits = wk.word_match_commit_multi(cps, tables, counts=counts, global_keys=True)
    assert _launch_counts() == before
    want_counts = []
    for cp, e in zip(cps, emits):
        want = word_match_commit(
            cp, tables.k1, tables.k2, tables.tid, width=int(cp.shape[1]), **tables.statics
        )
        assert e.dtype == torch.int32 and e.shape == cp.shape
        assert torch.equal(e, want)
        want_counts.append((want != -2).sum(dim=1, dtype=torch.int32))
    assert torch.equal(counts, torch.cat(want_counts))
    assert all((e != -2).any() for e in emits if e.shape[0])


def _cap_of(cap_kind: str, total: int) -> int:
    return {"ample": total + 5, "exact": total, "overflow": total // 2}[cap_kind]


@pytest.mark.parametrize("bucket_kind", ["mixed", "many_chunks"])
@pytest.mark.parametrize("cap_kind", ["ample", "exact", "overflow"])
def test_compact_from_counts_cpu_equals_plain(cap_kind, bucket_kind):
    """The compaction wrapper, given the counts in the vector, equals the
    plain compaction on every defined entry, with and without overflow,
    also where a bucket spans many of the kernel's 64-unit chunks."""
    _, tables, _ = _setup()
    cps = _mixed_buckets()
    if bucket_kind == "many_chunks":
        cps.append(torch.from_numpy(np.tile(cps[1].numpy(), (6, 1))))
        assert cps[-1].shape[0] > 4 * wk.COMPACT_CHUNK
    emits = wk.word_match_commit_multi(cps, tables)
    n = sum(int(e.shape[0]) for e in emits)
    total = sum(int((e != -2).sum()) for e in emits)
    cap = _cap_of(cap_kind, total)
    want = wk.compact_emits(emits, cap)
    fused = torch.full((1 + n + cap,), -9, dtype=torch.int32)
    fused[1 : 1 + n] = torch.cat([(e != -2).sum(dim=1, dtype=torch.int32) for e in emits])
    before = _launch_counts()
    got = wk.compact_from_counts(emits, fused, cap)
    assert got is fused and _launch_counts() == before
    kept = 1 + n + min(total, cap)
    assert int(got[0]) == total
    assert torch.equal(got[:kept], want[:kept])
    decoded = wk.decode_compact(got.numpy(), [tuple(e.shape) for e in emits], cap)
    if cap_kind != "overflow":
        for d, e in zip(decoded, emits):
            np.testing.assert_array_equal(d, e.numpy())
    else:
        assert decoded is None


def test_compact_from_counts_checks_its_vector():
    _, tables, mats = _setup()
    emits = wk.word_match_commit_multi([torch.from_numpy(_narrow(mats[7]["ascii"]))], tables)
    with pytest.raises(ValueError):
        wk.compact_from_counts(emits, torch.zeros(10, dtype=torch.int32), cap=8)
    wide = [torch.full((2, 129), -2, dtype=torch.int32)]
    with pytest.raises(ValueError):
        wk.compact_from_counts(wide, torch.zeros(1 + 2 + 4, dtype=torch.int32), cap=4)


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
        wk.word_match_commit_multi([torch.zeros(4, dtype=torch.int32)], tables)
    meta = torch.zeros((2, 7), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        wk.word_match_commit_multi([meta], tables)
    (empty,) = wk.word_match_commit_multi([torch.zeros((0, 7), dtype=torch.uint8)], tables)
    assert empty.shape == (0, 7) and empty.dtype == torch.int32

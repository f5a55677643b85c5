"""The CUDA kernel's packed slot layout of the length tables (pack_slots,
load_length_tables) against the tables it is built from: the occupied
slots of every (length, lane) in row order, for tables built by the JAX
package and by the port, for tables with empty lanes, and for a table
whose lanes hold gaps and repeated keys.  All integers: exact."""

import numpy as np
import pytest
import torch

from wordpiece_tpu.core.length_tables import build_length_tables as jax_build_tables
from wordpiece_tpu.core.vocab import parse_vocab as jax_parse_vocab
from wordpiece_tpu_torch.bench.corpus import make_corpus, make_vocab, make_vocab_bert
from wordpiece_tpu_torch.core import length_tables as lt
from wordpiece_tpu_torch.core.vocab import parse_vocab

torch.set_num_threads(1)

LANES = lt.LANES


def _row_scan_lists(k1, k2, tid, rows_off, max_len):
    """Reference: for every (length, lane), its occupied rows' (k1, k2,
    tid) in row order, by plain loops."""
    lists = {}
    for l in range(1, max_len + 1):
        for lane in range(LANES):
            lists[l, lane] = [
                (int(k1[r, lane]), int(k2[r, lane]), int(tid[r, lane]))
                for r in range(rows_off[l], rows_off[l + 1])
                if tid[r, lane] >= 0
            ]
    return lists


def _assert_layout(host_k1, host_k2, host_tid, rows_off, max_len):
    k1 = np.asarray(host_k1).view(np.int32)
    k2 = np.asarray(host_k2).view(np.int32)
    tid = np.asarray(host_tid, dtype=np.int32)
    off, sk1, sk2, stid = lt.pack_slots(k1, k2, tid, rows_off, max_len)
    assert off.shape == ((max_len + 1) * LANES + 1,)
    assert off[0] == 0 and (np.diff(off) >= 0).all() and off[LANES] == 0  # length 0: empty
    want = _row_scan_lists(k1, k2, tid, rows_off, max_len)
    for (l, lane), rows in want.items():
        a, b = off[l * LANES + lane], off[l * LANES + lane + 1]
        got = list(zip(sk1[a:b].tolist(), sk2[a:b].tolist(), stid[a:b].tolist()))
        assert got == rows, (l, lane)
    assert off[-1] == sk1.shape[0] == sum(len(r) for r in want.values())
    return off, sk1, sk2, stid


def _vocab_lines(kind):
    data = make_corpus(200_000)
    if kind == "bert":
        return make_vocab_bert(data)
    if kind == "v3000":
        return make_vocab(data, vocab_size=3000)
    return ["[UNK]", "a", "##a", "ab", "中", "х", "-", "▁x", "[CLS]", "!!"]


@pytest.mark.parametrize("kind", ["tiny", "v3000", "bert"])
@pytest.mark.parametrize("source", ["jax", "port"])
def test_slot_layout_equals_occupied_rows(source, kind):
    """Either package's tables give the layout of their occupied rows; the
    tiny vocabulary leaves most lanes of every length empty."""
    lines = _vocab_lines(kind)
    if source == "jax":
        host = jax_build_tables(jax_parse_vocab(lines))
    else:
        host = lt.build_length_tables(parse_vocab(lines))
    off, _, _, _ = _assert_layout(host.k1, host.k2, host.tid, host.rows_off, host.max_len)
    sizes = np.diff(off)[LANES:]
    if kind == "tiny":
        assert (sizes == 0).any()


def _gappy_table(seed=5):
    """A synthetic table no builder makes: empty slots in the middle of a
    lane, whole empty lanes and lengths, and one key repeated down a lane
    (so 'last hit wins' decides)."""
    rng = np.random.default_rng(seed)
    rows_off = [0, 0, 3, 3, 9]  # lengths 1..3; length 2 has no rows
    R = rows_off[-1]
    k1 = rng.integers(-(2**31), 2**31, size=(R, LANES), dtype=np.int64).astype(np.int32)
    k2 = rng.integers(-(2**31), 2**31, size=(R, LANES), dtype=np.int64).astype(np.int32)
    tid = rng.integers(0, 1000, size=(R, LANES)).astype(np.int32)
    tid[rng.random((R, LANES)) < 0.4] = -1
    tid[:, 5] = -1  # an empty lane at every length
    k1[3:9, 7] = 123
    k2[3:9, 7] = -456
    tid[3:9, 7] = [10, -1, 11, 12, -1, 13]
    return k1, k2, tid, rows_off, 3


def test_slot_layout_keeps_row_order_with_gaps():
    k1, k2, tid, rows_off, max_len = _gappy_table()
    off, sk1, sk2, stid = _assert_layout(k1, k2, tid, rows_off, max_len)
    assert off[3 * LANES + 5] == off[3 * LANES + 6]  # the empty lane
    a, b = off[3 * LANES + 7], off[3 * LANES + 8]
    assert stid[a:b].tolist() == [10, 11, 12, 13]


def test_packed_scan_finds_the_row_scans_last_hit():
    """For every occupied slot's key and some absent keys, a scan of the
    packed list in order finds the same last hit as the row scan over
    k1/k2/tid (the plain version's rule)."""
    k1, k2, tid, rows_off, max_len = _gappy_table()
    off, sk1, sk2, stid = lt.pack_slots(k1, k2, tid, rows_off, max_len)
    for l in range(1, max_len + 1):
        for lane in range(LANES):
            queries = {(int(k1[r, lane]), int(k2[r, lane]))
                       for r in range(rows_off[l], rows_off[l + 1])} | {(1, 2)}
            for q1, q2 in queries:
                row_hit = -1
                for r in range(rows_off[l], rows_off[l + 1]):
                    if k1[r, lane] == q1 and k2[r, lane] == q2 and tid[r, lane] >= 0:
                        row_hit = int(tid[r, lane])
                slot_hit = -1
                for s in range(off[l * LANES + lane], off[l * LANES + lane + 1]):
                    if sk1[s] == q1 and sk2[s] == q2:
                        slot_hit = int(stid[s])
                assert slot_hit == row_hit, (l, lane, q1, q2)
    a = off[3 * LANES + 7]
    assert stid[a] == 10 and stid[off[3 * LANES + 8] - 1] == 13


@pytest.mark.parametrize("source", ["jax", "port"])
def test_device_tables_slot_image(source):
    """load_length_tables stages the offsets and the k1 fingerprints as one
    image of 16-byte multiples, {k1, k2, tid} beside them, and keeps the
    interleaved tables of the plain version."""
    lines = _vocab_lines("v3000")
    if source == "jax":
        host = jax_build_tables(jax_parse_vocab(lines))
    else:
        host = lt.build_length_tables(parse_vocab(lines))
    dt = lt.load_length_tables(host, "cpu")
    off, sk1, sk2, stid = lt.pack_slots(host.k1, host.k2, host.tid, host.rows_off, host.max_len)
    assert dt.slot_image.dtype == torch.int32 and dt.slot_image.is_contiguous()
    assert dt.off_words % 4 == 0 and dt.slot_image.shape[0] % 4 == 0
    assert dt.off_words >= off.shape[0] and dt.n_slots == sk1.shape[0]
    np.testing.assert_array_equal(dt.slot_off.numpy(), off)
    assert not dt.slot_image[off.shape[0] : dt.off_words].any()
    np.testing.assert_array_equal(dt.slot_k1.numpy(), sk1)
    np.testing.assert_array_equal(dt.slot_k2.numpy(), sk2)
    np.testing.assert_array_equal(dt.slot_tid.numpy(), stid)
    assert dt.slot_keys.shape == (dt.n_slots, 4) and not dt.slot_keys[:, 3].any()
    fps = dt.slot_image[dt.off_words :].numpy().view(np.uint16)
    assert fps.shape[0] % 8 == 0 and not fps[dt.n_slots :].any()
    np.testing.assert_array_equal(fps[: dt.n_slots], lt.fingerprint(sk1))
    np.testing.assert_array_equal(dt.slot_fp.numpy().view(np.uint16), lt.fingerprint(sk1))
    np.testing.assert_array_equal(dt.k1.numpy(), host.k1)
    np.testing.assert_array_equal(dt.tid.numpy(), host.tid)


def test_device_tables_of_an_empty_table():
    """A vocabulary with no active token of any length: every list is
    empty, and the arrays the kernel takes still exist."""
    k1 = np.zeros((1, LANES), np.int32)
    tid = np.full((1, LANES), -1, np.int32)

    class Host:
        pass

    host = Host()
    host.k1, host.k2, host.tid = k1, k1, tid
    host.rows_off, host.max_len = [0, 0, 0], 1
    host.mult1 = host.mult2 = 3
    host.lane_salts, host.unk_token_id = (1, 1), 0
    dt = lt.load_length_tables(host, "cpu")
    assert dt.n_slots == 0 and not dt.slot_off.any()
    assert dt.slot_keys.shape == (1, 4) and dt.slot_image.shape[0] % 4 == 0


def test_fingerprint_folds_the_halves():
    k1 = np.array([0, 1, 0x10000, 0x12345678, -1, -(2**31)], dtype=np.int32)
    want = [0, 1, 1, 0x1234 ^ 0x5678, 0, 0x8000]
    assert lt.fingerprint(k1).tolist() == want
    assert lt.fingerprint(k1).dtype == np.uint16

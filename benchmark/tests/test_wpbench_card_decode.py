"""The fast-stream cell's share of bytes decoded on the card
(`stream_card_decode_pct`): its reader on canned records, with and
without the program's counter, and a traced run of the cell on the
program's CPU path, where the plain decode runs and the share reads 0."""

import time

import pytest

from wpbench import cell

CELL = "fast-stream.wiki-en-10MB"
NAME = "stream_card_decode_pct"
WINDOW = {"calls": 30, "bytes": 300_000_000, "seconds": 3.0}


def records(counters, window=WINDOW):
    return {"device": "NVIDIA H100 80GB HBM3", "window": window,
            "stages": {"encode": {"seconds": 0.3, "self_seconds": 0.01, "calls": 30},
                       "counters": counters},
            "trace": {"events": [], "calls": 2, "unit_bytes": 1}, "peaks": None}


def read(recs):
    return cell.Cell(CELL).reader(NAME)(recs)


@pytest.mark.parametrize("decoded,want", [(300_000_000, 100.0), (150_000_000, 50.0), (0, 0.0)],
                         ids=["every_byte", "half", "cpu"])
def test_reader(decoded, want):
    c = {"stream_positions": 30 * (3 << 22), "stream_card_decoded_bytes": decoded}
    assert read(records(c)) == pytest.approx(want)


@pytest.mark.parametrize("counters", [{"stream_positions": 30 * (3 << 22)}, {}, {"units_new": 5}],
                         ids=["host_decode", "no_counters", "other_engine"])
def test_a_program_without_the_counter_reads_nothing(counters):
    """The parent of the card decode counts no decoded bytes."""
    assert read(records(counters)) is None


def test_an_empty_window_reads_nothing():
    window = dict(WINDOW, calls=0, bytes=0)
    assert read(records({"stream_card_decoded_bytes": 0}, window)) is None


def test_the_entry():
    entry = [m for m in cell.Cell(CELL).per_layer if m["name"] == NAME]
    assert entry and entry[0]["moves"] == "device_memory_peak_MB" and entry[0]["workloads"] == [CELL]


def test_the_traced_cell_on_the_cpu_reads_0(small_root):
    c = cell.Cell(CELL, root=str(small_root))
    res = cell.run(c, 2**31 + 22, 0.5, True, t_start=time.monotonic(), device="cpu")
    out = res["result"]
    assert res["error"] is None and out["correct"] is True
    assert out["metrics"][NAME]["value"] == 0.0
    assert "host_decode_ms_per_MB" not in out["metrics"]

"""The linear cell's parts a segmentation call (`host_segment_parts`): its
reader on canned records, with and without the program's counter, and a
traced run of the cell on the program's CPU path, where the shrunk
documents are under the 512 KiB a part needs and each call runs one."""

import time

import pytest

from wpbench import cell

CELL = "linear.wiki-en-10MB"
NAME = "host_segment_parts"
WINDOW = {"calls": 30, "bytes": 300_000_000, "seconds": 3.0}


def records(counters, segment_calls=120):
    stages = {"encode": {"seconds": 3.0, "self_seconds": 0.1, "calls": 30}, "counters": counters}
    if segment_calls is not None:
        stages["host_segment_dedupe"] = {"seconds": 1.5, "self_seconds": 1.5,
                                         "calls": segment_calls}
    return {"device": "NVIDIA H100 80GB HBM3", "window": WINDOW, "stages": stages,
            "trace": {"events": [], "calls": 2, "unit_bytes": 1}, "peaks": None}


def read(recs):
    return cell.Cell(CELL).reader(NAME)(recs)


@pytest.mark.parametrize("parts,want", [(480, 4.0), (210, 1.75), (120, 1.0)],
                         ids=["wide", "two_way", "one_part"])
def test_reader(parts, want):
    assert read(records({"segment_parts": parts, "segment_pending": 5})) == pytest.approx(want)


@pytest.mark.parametrize("counters,segment_calls",
                         [({"units_new": 5}, 120), ({}, 120), ({"segment_parts": 4}, None),
                          ({"segment_parts": 0}, 0)],
                         ids=["parent", "no_counters", "no_stage", "no_calls"])
def test_a_program_without_the_counter_reads_nothing(counters, segment_calls):
    """The parent counts no parts; a window without segmentation reads
    nothing either."""
    assert read(records(counters, segment_calls)) is None


def test_the_entry():
    entry = [m for m in cell.Cell(CELL).per_layer if m["name"] == NAME]
    assert entry and entry[0]["moves"] == "device_memory_peak_MB" and entry[0]["workloads"] == [CELL]
    assert entry[0]["layer"] == "host native" and entry[0]["source"] == "program_counter"


def test_the_traced_cell_on_the_cpu_reads_1(small_root):
    c = cell.Cell(CELL, root=str(small_root))
    res = cell.run(c, 2**31 + 24, 0.5, True, t_start=time.monotonic(), device="cpu")
    out = res["result"]
    assert res["error"] is None and out["correct"] is True
    assert out["metrics"][NAME]["value"] == 1.0

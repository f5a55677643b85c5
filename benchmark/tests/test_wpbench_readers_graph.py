"""The readers of the linear engine's enqueue stage and graph counters, on
canned StageStats reports (the cases of test_wpbench_readers.py's kind)."""

import pytest

from wpbench import cell

WINDOW = {"calls": 40, "bytes": 100_000_000, "seconds": 2.0}


def read(name, stages):
    recs = {"device": "NVIDIA H100 80GB HBM3", "window": WINDOW, "stages": stages,
            "trace": {"events": [], "calls": 0, "unit_bytes": 0}, "peaks": None}
    return cell.Cell("linear.wiki-en-10MB").reader(name)(recs)


def test_enqueue_reads_its_stage_per_mb():
    stages = {"device_dispatch": {"seconds": 1.0, "calls": 360},
              "batch_enqueue": {"seconds": 0.05, "calls": 360}}
    assert read("host_enqueue_ms_per_MB", stages) == pytest.approx(0.5)


@pytest.mark.parametrize("counters,want", [
    ({"batches_graph": 342, "batches_eager": 18, "graph_captures": 18}, 95.0),
    ({"batches_graph": 360}, 100.0),
    ({"batches_eager": 9}, 0.0),
])
def test_graph_share_reads_the_counters(counters, want):
    assert read("graph_batch_pct", {"counters": counters}) == pytest.approx(want)


@pytest.mark.parametrize("name", ["host_enqueue_ms_per_MB", "graph_batch_pct"])
def test_a_program_without_them_reads_nothing(name):
    """The parent of the change has neither the stage nor the counters."""
    parent = {"device_dispatch": {"seconds": 1.0, "calls": 360},
              "counters": {"units_new": 78_000, "units_card": 78_000}}
    assert read(name, parent) is None
    assert read(name, {}) is None

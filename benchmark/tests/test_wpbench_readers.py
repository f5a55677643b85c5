"""Each per-layer metric's reader on canned records: a profiler trace in
Chrome-trace form, and the program's StageStats report."""

import json
import os

import pytest
from conftest import BENCH, ROOT

from wpbench import cell, trace


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


# A traced window of 1,000 us holding two calls: 3 kernels (100 us in
# all, 20 of them overlapping), a copy and a memset; a stage span on the host.
EVENTS = [
    ev("user_annotation", trace.WINDOW, 1000.0, 1000.0),
    ev("user_annotation", trace.CALL, 1000.0, 400.0),
    ev("user_annotation", trace.CALL, 1500.0, 500.0),
    ev("user_annotation", "host_segment_dedupe", 1020.0, 300.0),
    ev("kernel", "word_kernel", 1350.0, 40.0),
    ev("kernel", "compact", 1370.0, 30.0),
    ev("gpu_memcpy", "Memcpy DtoH", 1400.0, 10.0),
    ev("kernel", "word_kernel", 1900.0, 30.0),
    ev("gpu_memset", "Memset", 1950.0, 10.0),
    ev("gpu_user_annotation", trace.CALL, 1000.0, 1000.0),
    ev("kernel", "outside", 3000.0, 50.0),
    ev("cuda_runtime", "cudaLaunchKernel", 1340.0, 5.0),
]
STAGES = {
    "host_segment_dedupe": {"seconds": 0.5, "calls": 40},
    "host_expand": {"seconds": 0.1, "calls": 40},
    "device_fetch": {"seconds": 0.02, "calls": 40},
}
PEAKS = {"hbm_bytes_per_s": 3.35e12}


def records(events=EVENTS, stages=STAGES, peaks=PEAKS, unit_bytes=335_000):
    return {"device": "NVIDIA H100 80GB HBM3", "window": {"calls": 40, "bytes": 100_000_000, "seconds": 2.0},
            "stages": stages, "trace": {"events": events, "calls": 2, "unit_bytes": unit_bytes},
            "peaks": peaks}


def read(name, recs):
    return cell.Cell("fast.wiki-en-10MB").reader(name)(recs)


def test_trace_reduction():
    assert trace.window(EVENTS) == (1000.0, 2000.0)
    assert trace.busy_us(EVENTS) == pytest.approx(50 + 10 + 30 + 10)  # 1350-1400, 1400-1410, 1900-1930, 1950-1960
    assert trace.kernel_us(EVENTS) == pytest.approx(100)
    assert trace.count(EVENTS, "kernel") == 3
    b = trace.breakdown(EVENTS)
    assert b["device_ops"][0] == ["word_kernel", pytest.approx(70e-6)]
    longest = b["idle_gaps"][0]
    assert longest[0] == trace.CALL and longest[1] == pytest.approx(490e-6)  # 1410-1900
    labels = {g[0] for g in b["idle_gaps"]}
    assert "host_segment_dedupe" in labels  # 1000-1350, its middle inside the stage


@pytest.mark.parametrize("name,want", [
    ("launches_per_call", 1.5),
    ("host_segment_ms_per_MB", 5.0),
    ("host_expand_ms_per_MB", 1.0),
    ("device_fetch_us_per_call", 500.0),
    ("kernels_roofline_pct", 100.0 * (335_000 / 3.35e12) / 100e-6),
    ("device_idle_pct.bulk", 90.0),
])
def test_reader(name, want):
    assert read(name, records()) == pytest.approx(want)


@pytest.mark.parametrize("name", ["encode_MBps.fast", "encode_MBps.linear", "encode_MBps.stream"])
def test_the_window_rate_per_layer(name):
    assert read(name, records()) == pytest.approx(50.0)
    empty = dict(records(), window={"calls": 0, "bytes": 0, "seconds": 0.0})
    assert read(name, empty) is None


@pytest.mark.parametrize("name", [
    "launches_per_call", "host_segment_ms_per_MB", "host_expand_ms_per_MB", "device_fetch_us_per_call",
    "kernels_roofline_pct", "device_idle_pct.bulk",
])
def test_a_split_metric_reads_as_its_base(name):
    """`<metric>.fast` moves another end-to-end metric, and reads the same."""
    host_only = [e for e in EVENTS if e["cat"] in ("user_annotation", "cuda_runtime")]
    for recs in (records(), records(events=host_only), records(stages={}), records(peaks=None)):
        assert read(name + ".fast", recs) == read(name, recs)


@pytest.mark.parametrize("name", [
    "launches_per_call", "kernels_roofline_pct", "device_idle_pct.bulk",
])
def test_a_trace_without_device_events_reads_nothing(name):
    host_only = [e for e in EVENTS if e["cat"] in ("user_annotation", "cuda_runtime")]
    assert read(name, records(events=host_only)) is None


@pytest.mark.parametrize("name", ["host_segment_ms_per_MB", "host_expand_ms_per_MB", "device_fetch_us_per_call"])
def test_a_program_without_the_stage_reads_nothing(name):
    assert read(name, records(stages={})) is None


def test_roofline_needs_a_known_card():
    assert read("kernels_roofline_pct", records(peaks=None)) is None


def test_every_per_layer_metric_has_a_reader():
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        names = [m["name"] for m in json.load(f)["per_layer"]]
    assert sorted(names) == sorted(f[:-3] for f in os.listdir(os.path.join(BENCH, "metrics")) if f.endswith(".py"))

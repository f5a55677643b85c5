"""The per-layer metrics that read the program's caller-thread spans and
route counters: each on canned records (StageStats reports with and
without the spans, as a program that lacks them gives), each `.fast`
twin against its base, and a traced CPU run of each shrunk 10 MB cell."""

import time

import pytest

from wpbench import cell

# A window of 40 calls over 100 MB (records["window"] as cell.run makes it).
WINDOW = {"calls": 40, "bytes": 100_000_000, "seconds": 2.0}
STAGES = {
    "encode": {"seconds": 2.0, "self_seconds": 0.1, "calls": 40, "bytes": 100_000_000},
    "wait_worker": {"seconds": 0.5, "self_seconds": 0.5, "calls": 120},
    "device_fetch": {"seconds": 0.4, "self_seconds": 0.4, "calls": 80, "bytes": 100_000_000},
    "device_wait": {"seconds": 0.05, "self_seconds": 0.05, "calls": 80},
    "fetch_unpack": {"seconds": 0.03, "self_seconds": 0.03, "calls": 80},
    "host_segment_dedupe": {"seconds": 0.9, "self_seconds": 0.9, "calls": 160, "bytes": 100_000_000},
    "counters": {"units_new": 4_000_000, "units_card": 3_000_000, "units_host": 1_000_000},
}
# What a program without the new spans and counters reports (the parent's StageStats).
OLD = {
    "host_segment_dedupe": {"seconds": 0.9, "calls": 160, "bytes": 100_000_000},
    "device_fetch": {"seconds": 0.4, "calls": 80, "bytes": 100_000_000},
}
NEW = ["encode_unstaged_pct", "host_worker_wait_ms_per_MB", "device_fetch_wait_us_per_call",
       "device_fetch_hop_us_per_call"]


def records(stages=STAGES, window=WINDOW):
    return {"device": "NVIDIA H100 80GB HBM3", "window": window, "stages": stages,
            "trace": {"events": [], "calls": 0, "unit_bytes": 0}, "peaks": None}


def read(name, recs):
    return cell.Cell("fast.wiki-en-10MB").reader(name)(recs)


def without(*names):
    return {k: v for k, v in STAGES.items() if k not in names}


@pytest.mark.parametrize("name,want", [
    ("encode_unstaged_pct", 5.0),
    ("host_worker_wait_ms_per_MB", 5.0),
    ("device_fetch_wait_us_per_call", 1250.0),
    ("device_fetch_hop_us_per_call", (0.4 - 0.05 - 0.03) * 1e6 / 40),
    ("host_units_pct", 25.0),
])
def test_reader(name, want):
    assert read(name, records()) == pytest.approx(want)


@pytest.mark.parametrize("name", NEW + ["host_units_pct"])
def test_a_program_without_the_spans_reads_nothing(name):
    assert read(name, records(stages=OLD)) is None
    assert read(name, records(stages={})) is None


def test_a_call_that_never_waits_reads_zero():
    assert read("host_worker_wait_ms_per_MB", records(stages=without("wait_worker"))) == 0.0
    assert read("host_worker_wait_ms_per_MB", records(stages=without("encode"))) is None


def test_the_hop_is_floored_at_zero():
    stages = dict(STAGES, device_wait={"seconds": 0.39, "self_seconds": 0.39, "calls": 80})
    assert read("device_fetch_hop_us_per_call", records(stages=stages)) == 0.0


@pytest.mark.parametrize("name,gone", [
    ("device_fetch_wait_us_per_call", "device_fetch"),
    ("device_fetch_wait_us_per_call", "device_wait"),
    ("device_fetch_hop_us_per_call", "device_fetch"),
    ("device_fetch_hop_us_per_call", "fetch_unpack"),
    ("encode_unstaged_pct", "encode"),
])
def test_a_missing_stage_reads_nothing(name, gone):
    assert read(name, records(stages=without(gone))) is None


def test_units_need_first_seen_units():
    assert read("host_units_pct", records(stages=without("counters"))) is None
    zero = dict(STAGES, counters={"units_new": 0, "units_card": 0, "units_host": 0})
    assert read("host_units_pct", records(stages=zero)) is None
    card_only = dict(STAGES, counters={"units_new": 10, "units_card": 10})
    assert read("host_units_pct", records(stages=card_only)) == 0.0


def test_an_empty_window_reads_nothing():
    """The per-MB and per-call readings; the unstaged share is a ratio of
    one stage and needs no window."""
    empty = {"calls": 0, "bytes": 0, "seconds": 0.0}
    for name in NEW[1:]:
        assert read(name, records(window=empty)) is None


@pytest.mark.parametrize("name", NEW)
def test_a_split_metric_reads_as_its_base(name):
    for stages in (STAGES, OLD, {}, without("wait_worker"), without("fetch_unpack")):
        assert read(name + ".fast", records(stages=stages)) == read(name, records(stages=stages))


@pytest.mark.parametrize("name", ["fast.wiki-en-10MB", "linear.wiki-en-10MB"])
def test_a_traced_cpu_run_reads_every_new_metric(small_root, name):
    c = cell.Cell(name, root=str(small_root))
    out = cell.run(c, 2**31 + 11, 0.5, True, t_start=time.monotonic(), device="cpu")["result"]
    assert out["correct"] is True
    suffix = ".fast" if name.startswith("fast.") else ""
    want = [m + suffix for m in NEW] + (["host_units_pct"] if suffix else [])
    got = out["metrics"]
    assert set(want) <= set(got)
    assert 0.0 <= got["encode_unstaged_pct" + suffix]["value"] < 100.0
    assert all(got[m]["value"] >= 0.0 for m in want)
    if suffix:
        assert 0.0 < got["host_units_pct"]["value"] < 100.0
    else:  # linear segments on its worker thread even in a one-piece call
        assert got["host_worker_wait_ms_per_MB"]["value"] > 0.0

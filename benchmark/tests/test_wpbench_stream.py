"""The fast-stream cell: a run of it on the program's CPU path, its
per-layer readers on canned records (with and without the program's
stages, counters and kernels), and the kernels' byte counts against
chip_smoke.py's."""

import ast
import json
import os
import time

import numpy as np
import pytest
from conftest import BENCH

from wpbench import cell, stream_bytes, trace

CELL = "fast-stream.wiki-en-10MB"
SPANS = ["stream_staging_ms_per_MB", "stream_fetch_ms_per_MB"]
ROOFLINES = ["stream_features_roofline_pct", "stream_match_roofline_pct", "stream_commit_roofline_pct"]

N = 3 << 22  # the bucket of a 10 MB document
ROWS = 1 << 17
CALLS = 30  # the window's
WINDOW = {"calls": CALLS, "bytes": 300_000_000, "seconds": 3.0}
STAGES = {
    "encode": {"seconds": 3.0, "self_seconds": 0.01, "calls": CALLS, "bytes": 300_000_000},
    "host_pad": {"seconds": 0.6, "self_seconds": 0.6, "calls": CALLS},
    "stream_h2d": {"seconds": 0.3, "self_seconds": 0.3, "calls": CALLS},
    "device_dispatch": {"seconds": 0.003, "self_seconds": 0.003, "calls": CALLS},
    "device_fetch": {"seconds": 0.045, "self_seconds": 0.005, "calls": CALLS},
    "counters": {"stream_positions": CALLS * N, "stream_table_rows": CALLS * ROWS},
}
# The kernels of two traced calls, as the profiler names them on the card (us).
KERNELS = {
    "void (anonymous namespace)::text_features_kernel<16>(int const*, int, int, int, int, void*)": 120.0,
    "void (anonymous namespace)::match_positions_kernel<true, true>(int const*, int const*)": 250.0,
    "(anonymous namespace)::commit_walk_kernel(int const*, int const*, int, int, void*)": 100.0,
    "(anonymous namespace)::commit_emit_kernel(int const*, unsigned char const*, int, int)": 90.0,
    "(anonymous namespace)::commit_fill_kernel(int const*, int, int*, int*)": 30.0,
}
PEAKS = {"hbm_bytes_per_s": 3.35e12}


def events(kernels=KERNELS, calls=2):
    out = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 0.0, "dur": 1e6}]
    t = 100.0
    for _ in range(calls):
        for name, us in kernels.items():
            out.append({"ph": "X", "cat": "kernel", "name": name, "ts": t, "dur": us})
            t += us + 10.0
    out.append({"ph": "X", "cat": "kernel", "name": "text_features_kernel outside", "ts": 2e6, "dur": 99.0})
    return out


def records(stages=STAGES, evs=None, peaks=PEAKS):
    return {"device": "NVIDIA H100 80GB HBM3", "window": WINDOW, "stages": stages,
            "trace": {"events": events() if evs is None else evs, "calls": 2, "unit_bytes": 1},
            "peaks": peaks}


def read(name, recs):
    return cell.Cell(CELL).reader(name)(recs)


def share(nbytes, us):
    return 100.0 * nbytes / 3.35e12 / (us * 1e-6)


@pytest.mark.parametrize("name,want", [
    ("stream_staging_ms_per_MB", 3.0),
    ("stream_fetch_ms_per_MB", 0.15),
    ("stream_features_roofline_pct", share(20 * N + 8, 120.0)),
    ("stream_match_roofline_pct", share(17 * N + 20 * ROWS, 250.0)),
    ("stream_commit_roofline_pct", share(30 * N + 12, 220.0)),
])
def test_reader(name, want):
    assert read(name, records()) == pytest.approx(want)


def test_a_roofline_reads_the_time_a_call():
    """A dropped event (the profiler's first kernel) leaves the time a
    call as it is; a kernel run twice a call counts both runs."""
    name = "stream_features_roofline_pct"
    want = read(name, records())
    assert read(name, records(evs=events()[:1] + events()[2:])) == pytest.approx(want)
    assert read(name, records(evs=events(calls=4))) == pytest.approx(want / 2)


@pytest.mark.parametrize("name,gone", [
    ("stream_staging_ms_per_MB", "host_pad"),
    ("stream_staging_ms_per_MB", "stream_h2d"),
    ("stream_fetch_ms_per_MB", "device_fetch"),
] + [(name, "counters") for name in ROOFLINES])
def test_a_missing_stage_or_counter_reads_nothing(name, gone):
    assert read(name, records(stages={k: v for k, v in STAGES.items() if k != gone})) is None


@pytest.mark.parametrize("name", ROOFLINES)
def test_a_roofline_without_its_kernels_or_peaks_reads_nothing(name):
    key = name.split("_")[1]  # features, match, commit
    others = {k: v for k, v in KERNELS.items() if key not in k}
    assert read(name, records(evs=events(others))) is None
    assert read(name, records(evs=[])) is None
    assert read(name, records(peaks=None)) is None


@pytest.mark.parametrize("name", SPANS + ROOFLINES)
def test_the_parent_program_reads_nothing(name):
    """The other engines' stages, with no fast-stream counter, and a trace
    with no fast-stream kernel."""
    old = {"device_fetch": STAGES["device_fetch"], "host_segment_dedupe": STAGES["host_pad"],
           "counters": {"units_new": 5}}
    want_none = name != "stream_fetch_ms_per_MB"  # that stage is every engine's
    assert (read(name, records(stages=old, evs=events({"word_kernel": 10.0}))) is None) == want_none


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
def test_the_cell_runs_on_the_cpu(small_root, traced):
    c = cell.Cell(CELL, root=str(small_root))
    res = cell.run(c, 2**31 + 21, 0.5, traced, t_start=time.monotonic(), device="cpu")
    out = res["result"]
    assert res["error"] is None and out["correct"] is True and out["failed"] == 0
    assert out["compared"]["ids_wrong"]["value"] == 0 and res["info"]["calls_checked"] >= 1
    if traced:  # on the CPU: the spans and the card's share of the decode (0), no kernel to read
        assert set(out["metrics"]) == set(SPANS) | {"stream_card_decode_pct", "encode_MBps.stream"}
        assert out["metrics"]["stream_card_decode_pct"]["value"] == 0
    else:
        rate = {m["name"] for m in c.end_to_end if m["name"] == "encode_MBps"}
        assert set(out["metrics"]) == {"setup_s"} | rate
        assert "device_memory_peak_MB" in {m["name"] for m in c.end_to_end}
    json.dumps(res)


def test_the_entry_is_the_programs_encode_bytes():
    c = cell.Cell(CELL)
    assert (c.config["engine"], c.config["entry"]) == ("fast-stream", "encode_bytes")

    class Program:
        def encode_bytes(self, data):
            return data

    p = Program()
    assert cell.entry(p, c.config["entry"]) == p.encode_bytes


def test_byte_counts_import_nothing_of_the_program():
    for name in ("stream_bytes.py", "rooflines.py"):
        with open(os.path.join(BENCH, "wpbench", name), encoding="utf-8") as f:
            tree = ast.parse(f.read())
        mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        mods += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.level == 0]
        assert not [m for m in mods if m.split(".")[0] in ("wordpiece_tpu", "wordpiece_tpu_torch", "jax", "torch")]


@pytest.mark.parametrize("size", [100, 1_000, 5_000])
def test_byte_counts_equal_chip_smoke(size):
    import chip_smoke
    import torch

    from wordpiece_tpu_torch.bench.corpus import make_corpus, make_vocab
    from wordpiece_tpu_torch.core import unicode as uni
    from wordpiece_tpu_torch.core.vocab import parse_vocab
    from wordpiece_tpu_torch.engine import FastEncoder, bucket_size, pad_codepoints
    from wordpiece_tpu_torch.ops.text_features import compute_features

    data = make_corpus(20_000, seed=29)
    enc = FastEncoder(parse_vocab(make_vocab(data, vocab_size=600, seed=29)), device="cpu")
    cps = uni.decode_utf8(data[:size]).astype(np.int32)
    st = enc._statics
    cp_pad = torch.from_numpy(pad_codepoints(cps, st["max_len"]))
    n = bucket_size(cps.shape[0])
    feats = compute_features(cp_pad[:n], cps.shape[0], st["max_len"])
    rows = enc.table.rows
    want = chip_smoke.stream_bytes_ops(cp_pad, feats.window, feats.wp, rows, st)[0]
    assert stream_bytes.match_bytes(n, rows.shape[0]) == want
    assert stream_bytes.features_bytes(n) == chip_smoke.features_bytes_ops(n)[0]
    assert stream_bytes.commit_bytes(n) == chip_smoke.commit_bytes_ops(n)[0]

"""BENCHMARK.json and every file it names: present, loadable, and within
the names, units and limits the benchmark's contract allows."""

import json
import os
import re

import pytest
from conftest import BENCH, ROOT

from wpbench.cell import reader_at

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")

with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
    B = json.load(f)
METRICS = B["end_to_end"] + B["per_layer"]


def line_ok(s: str, limit: int = 200) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= limit and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert B["command"] == ["python3", "benchmark/run.py"]
    assert B["paths"] == ["benchmark"]
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    # the full check of 24 cells fits its time: 2 + 14 a cell runs, 90 s a compile
    assert (2 + 14 * 24) * (B["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("entry", B["configs"], ids=lambda c: c["name"])
def test_config(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and line_ok(entry["source"]) and line_ok(entry["why"])
    assert PATH.match(entry["file"]) and entry["file"].startswith("benchmark/")
    with open(os.path.join(ROOT, entry["file"]), encoding="utf-8") as f:
        cfg = json.load(f)
    assert cfg["name"] == entry["name"]
    assert cfg["entry"] in ("encode_bytes", "encode_codepoints")
    assert cfg["vocab_size"] > 0 and isinstance(cfg["zero_counters"], list)
    assert all(NAME.match(k) for k in entry["reduced"]) and len(entry["reduced"]) <= 16
    assert any(w["config"] == entry["name"] for w in B["workloads"])


@pytest.mark.parametrize("cell", B["workloads"], ids=lambda w: w["name"])
def test_workload(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and line_ok(cell["why"])
    assert cell["config"] in {c["name"] for c in B["configs"]} and cell["chips"] in (1, 4)
    with open(os.path.join(BENCH, "traffic", cell["traffic"] + ".json"), encoding="utf-8") as f:
        mix = json.load(f)
    assert mix["name"] == cell["traffic"]
    for key in ("word_types", "zipf_exponent", "pool_bytes", "vocab_sample_bytes"):
        assert mix["corpus"][key] > 0
    for key in ("warmup_calls", "check_calls", "trace_calls"):
        assert mix[key] >= 1
    reported = [m for m in METRICS if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in {m["name"] for m in reported}
    assert len([m for m in reported if m in B["end_to_end"]]) >= 2
    assert any(m in B["per_layer"] for m in reported)


@pytest.mark.parametrize("path", sorted(os.listdir(os.path.join(BENCH, "traffic"))))
def test_every_mix_file_loads(path):
    with open(os.path.join(BENCH, "traffic", path), encoding="utf-8") as f:
        mix = json.load(f)
    assert path == mix["name"] + ".json" and NAME.match(mix["name"])
    docs = mix["documents"]
    assert docs.get("bytes", 0) > 0 or 0 < docs["min_bytes"] <= docs["median_bytes"] <= docs["max_bytes"]


def test_names_are_unique_and_pairs_appear_once():
    for group in (B["configs"], B["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in B["workloads"])
    assert four <= max(1, len(B["workloads"]) // 4)


@pytest.mark.parametrize("metric", B["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(metric):
    assert set(metric) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher") and metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25


@pytest.mark.parametrize("metric", B["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(metric):
    assert set(metric) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"]) and line_ok(metric["layer"])
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    moves = {m["name"]: m for m in B["end_to_end"]}[metric["moves"]]
    for cell in metric.get("workloads", [w["name"] for w in B["workloads"]]):
        assert cell in {w["name"] for w in B["workloads"]}
        assert cell in moves.get("workloads", [cell])
    if metric["name"].endswith("_roofline") or metric["name"].endswith("_roofline_pct"):
        assert metric["unit"] == "%"
    assert callable(reader_at(os.path.join(BENCH, "metrics", metric["name"] + ".py")))


def test_layers_are_named_alike():
    layers = {m["layer"] for m in B["per_layer"]}
    with open(os.path.join(ROOT, "PERF.md"), encoding="utf-8") as f:
        perf = f.read()
    for layer in layers:
        assert f"| {layer} |" in perf, f"PERF.md's list of layers lacks {layer!r}"


def test_files_under_paths_are_named_from_name_characters():
    for dirpath, dirnames, files in os.walk(BENCH):
        dirnames[:] = [d for d in dirnames if d not in ("__pycache__", ".pytest_cache")]
        for name in files:
            rel = os.path.relpath(os.path.join(dirpath, name), ROOT)
            assert PATH.match(rel), rel

"""Whole runs on the program's CPU path at small sizes: the result line's
keys, the check of the JAX imports, and the refusals the contract asks
for (no card; a checkout without the program)."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
from conftest import BENCH, ROOT

from wpbench import cell

CELLS = ["fast.wiki-en-10MB", "linear.wiki-en-10MB", "fast.wiki-en-articles", "linear.wiki-en-articles"]
with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as _f:
    BENCH_CELLS = [w["name"] for w in json.load(_f)["workloads"]]
REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]


def run_small(root, name, traced, seed=2**31 + 7, **kw):
    return cell.run(cell.Cell(name, root=str(root)), seed, 0.5, traced, t_start=time.monotonic(),
                    device="cpu", **kw)


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("name", CELLS)
def test_result_line(small_root, name, traced):
    res = run_small(small_root, name, traced)
    out = res["result"]
    keys = list(out)
    assert keys[:5] == REQUIRED and keys[-1] == "compared"
    assert set(keys) == set(REQUIRED) | {"compared"} | ({"breakdown"} if traced else set())
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    c = cell.Cell(name, root=str(small_root))
    want = {m["name"] for m in (c.per_layer if traced else c.end_to_end)}
    if traced:  # on the CPU only the program's stages and the window can be read
        assert set(out["metrics"]) == {m for m in want if m.startswith(("host_", "device_fetch", "encode_"))}
        assert len(out["breakdown"]["device_ops"]) <= 10 and len(out["breakdown"]["idle_gaps"]) <= 10
    else:  # a device's reading, such as its memory peak, exists only on the card
        assert set(out["metrics"]) == {m["name"] for m in c.end_to_end if m["source"] != "device_trace"}
        assert all(v["value"] > 0 for v in out["metrics"].values())
    for v in out["compared"].values():
        assert set(v) == {"value", "limit"} and v["value"] <= v["limit"]
    assert {"memory_peak_bytes", "count", "kind", "platform"} <= set(out["device"])
    json.dumps(res)


def test_no_banned_module_in_this_process_after_a_run(small_root):
    run_small(small_root, "fast.wiki-en-articles", False)
    assert cell.banned_modules(list(sys.modules)) == []


def test_banned_names_are_compared_whole():
    assert cell.banned_modules(["jax", "numpy"]) == ["jax"]
    assert cell.banned_modules(["jax.numpy", "jaxlib.xla_client", "flax.linen"]) == ["flax", "jax", "jaxlib"]
    assert cell.banned_modules(["wordpiece_tpu.api", "wordpiece_tpu_torch.api"]) == ["wordpiece_tpu"]
    assert cell.banned_modules(["wordpiece_tpu_torch", "wordpiece_tpu_torch.engine_word"]) == []
    assert cell.banned_modules(["jaxtyping", "flaxen"]) == []


def test_the_yardstick_imports_nothing_of_the_program():
    """The reference, the generator and the trace reduction take nothing
    from the program; only cell.py reaches it, inside functions."""
    import ast

    for name in ("reference.py", "corpus.py", "traffic.py", "trace.py", "stages.py"):
        with open(os.path.join(BENCH, "wpbench", name), encoding="utf-8") as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for m in mods:
                assert m.split(".")[0] not in ("wordpiece_tpu", "wordpiece_tpu_torch", "jax", "torch"), (name, m)


def test_without_a_card_no_result_and_a_failing_exit():
    if __import__("torch").cuda.is_available():
        pytest.skip("this machine has a card")
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""


@pytest.mark.chip
@pytest.mark.parametrize("name", BENCH_CELLS)
def test_each_cell_on_the_card(chip, name):
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed", "2147483659",
                          "--seconds", "2", "--trace", "1"], cwd=ROOT, capture_output=True, text=True,
                         timeout=360)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0

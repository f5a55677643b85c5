"""One run of one cell: set-up, the measured window, the traced calls, the check.

Everything a cell is made of is found by name under the checkout: the
cell in BENCHMARK.json, its configuration in the file that entry names,
its traffic mix in benchmark/traffic/<mix>.json, each per-layer metric in
benchmark/metrics/<metric>.py (a `read(records)` that returns a number,
or None where it finds nothing to read).
The program is driven through `wordpiece_tpu_torch.make_encoder` with the
configuration's engine, one closed loop of one caller, each call a fresh
document; its ids are held against the plain reference (reference.py)
once the window has closed.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import random
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

from . import trace
from .corpus import STREAM_CHECK, Corpus
from .reference import Reference
from .traffic import Documents

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # benchmark/
ROOT = os.path.dirname(HERE)  # the checkout
# Top-level modules no process of the benchmark may load: the JAX package
# is the port's reference on the CPU, never part of what is measured.
BANNED = ("jax", "jaxlib", "flax", "wordpiece_tpu")
PEAKS = os.path.join(HERE, "wpbench", "peaks.json")


def banned_modules(names) -> list[str]:
    """The banned top-level names among module names, compared whole:
    `wordpiece_tpu_torch` is not `wordpiece_tpu`."""
    return sorted({n.split(".")[0] for n in names} & set(BANNED))


def _load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


class Cell:
    """A workload of BENCHMARK.json with its configuration, mix and metrics."""

    def __init__(self, name: str, root: str = ROOT):
        bench = _load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = cells[name]
        self.name = name
        entry = {c["name"]: c for c in bench["configs"]}[self.workload["config"]]
        self.config = _load_json(os.path.join(root, entry["file"]))
        self.data = os.path.join(root, os.path.basename(HERE))
        self.mix = _load_json(os.path.join(self.data, "traffic", self.workload["traffic"] + ".json"))
        self.end_to_end = [m for m in bench["end_to_end"] if self._applies(m)]
        self.per_layer = [m for m in bench["per_layer"] if self._applies(m)]

    def _applies(self, metric: dict) -> bool:
        return self.name in metric.get("workloads", [self.name])

    def reader(self, metric: str):
        return reader_at(os.path.join(self.data, "metrics", metric + ".py"))


def reader_at(path: str):
    """The `read` of the per-layer metric reader in the file at `path`."""
    name = os.path.basename(path)[: -len(".py")]
    spec = importlib.util.spec_from_file_location("metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Sample:
    """The calls whose ids are checked: a uniform sample of `k` of them,
    drawn from the seed as they come (a reservoir), and the longest."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed * 8 + STREAM_CHECK)
        self.items: list[tuple[int, np.ndarray]] = []
        self.seen = 0
        self.longest: tuple[int, int, np.ndarray] | None = None

    def offer(self, i: int, size: int, ids: np.ndarray) -> None:
        if len(self.items) < self.k:
            self.items.append((i, ids))
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = (i, ids)
        self.seen += 1
        if self.longest is None or size > self.longest[1]:
            self.longest = (i, size, ids)

    def chosen(self) -> dict[int, np.ndarray]:
        out = dict(self.items)
        if self.longest is not None:
            out[self.longest[0]] = self.longest[2]
        return out


def span_stages():
    """The program's StageStats, with each stage also a span in the trace."""
    from torch.profiler import record_function
    from wordpiece_tpu_torch.utils.profiling import StageStats

    class SpanStages(StageStats):
        @contextlib.contextmanager
        def stage(self, name: str, nbytes: int = 0):
            with record_function(name), super().stage(name, nbytes):
                yield

    return SpanStages()


def entry(encoder, how: str):
    """The call the window times, by the configuration's `entry`."""
    if how == "encode_bytes":
        return encoder.encode_bytes
    if how == "encode_codepoints":
        from wordpiece_tpu_torch.core.unicode import decode_utf8

        return lambda doc: encoder.encode_codepoints(decode_utf8(doc))
    raise ValueError(f"unknown entry {how!r}")


def window(encode, docs: Documents, seconds: float, sample: Sample) -> dict:
    """Calls one after another until `seconds` have passed; the window
    closes when the call running at that moment returns."""
    lat: list[float] = []
    nbytes = 0
    error = None
    i = 0
    clock = time.perf_counter
    cpu0, w0 = time.process_time(), clock()
    deadline = w0 + seconds
    while True:
        doc = docs.doc(i)
        c0 = clock()
        try:
            ids = encode(doc)
        except Exception:  # a failed call ends the run; it is reported, not hidden
            error = traceback.format_exc()
            break
        c1 = clock()
        lat.append(c1 - c0)
        nbytes += len(doc)
        sample.offer(i, len(doc), ids)
        i += 1
        if c1 >= deadline:
            break
    w1, cpu1 = clock(), time.process_time()
    return {"calls": len(lat), "bytes": nbytes, "seconds": w1 - w0,
            "cpu_s": cpu1 - cpu0, "lat": np.asarray(lat), "error": error}


def e2e(w: dict) -> dict:
    """The window's rates; BENCHMARK.json says which a cell reports (with
    `setup_s`, and on the card `device_memory_peak_MB`: the allocator's
    peak over set-up and window, in 10^6 bytes)."""
    mb = w["bytes"] / 1e6
    return {
        "encode_MBps": mb / w["seconds"],
        "call_p95_ms": float(np.percentile(w["lat"], 95)) * 1e3,
        "host_cpu_ms_per_MB": w["cpu_s"] * 1e3 / mb,
    }


def all_threads():
    """The profiler's option to record the spans of every thread (the
    program runs stages on worker threads), where this torch has it."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


def traced_calls(encode, docs: Documents, first: int, n: int, on_cuda: bool):
    """`n` calls under torch.profiler; -> (trace events, {call: ids})."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda else [])
    out = {}
    with profile(activities=acts, experimental_config=all_threads()) as prof:
        with record_function(trace.WINDOW):
            for i in range(first, first + n):
                doc = docs.doc(i)
                with record_function(trace.CALL):
                    out[i] = encode(doc)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        events = _load_json(path)["traceEvents"]
    return events, out


def power_limit() -> str | None:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return res.stdout.strip() or None


def program(cell: Cell, device: str):
    """The system under test: vocab lines -> the configuration's encoder."""
    from wordpiece_tpu_torch import make_encoder, parse_vocab

    return lambda lines: make_encoder(parse_vocab(lines), engine=cell.config["engine"], device=device)


def run(cell: Cell, seed: int, seconds: float, traced: bool, *, t_start: float,
        device: str = "cuda", make=None) -> dict:
    """One run; returns {"result": the last line, "info": the line before,
    "error": a failed call's traceback or None}.  `device="cpu"` runs the
    program's CPU path and `make` (vocab lines -> encoder) stands in for
    the program: both for the control and the benchmark's own tests."""
    import torch

    on_cuda = device == "cuda"
    cfg, mix = cell.config, cell.mix
    parts = {"imports": time.monotonic() - t_start}
    if on_cuda:
        torch.zeros(1, device=device)
    parts["cuda"] = time.monotonic() - t_start
    corpus = Corpus(mix["corpus"], seed, int(cfg["vocab_size"]), cfg.get("vocab_sample"))
    docs = Documents(mix["documents"], corpus.pool, seed, int(mix["warmup_calls"]))
    parts["traffic"] = time.monotonic() - t_start
    encoder = (make or program(cell, device))(corpus.vocab_lines)
    encode = entry(encoder, cfg["entry"])
    parts["encoder"] = time.monotonic() - t_start
    stats = span_stages() if traced else None
    if traced:
        from torch.profiler import profile

        with profile():  # the profiler's own start-up, before anything is traced
            pass
        encoder.stats = stats
    for doc in docs.warmup():
        encode(doc)
    if on_cuda:
        torch.cuda.synchronize()
    if stats is not None:
        stats.reset()
    setup_s = time.monotonic() - t_start
    parts["warmup"] = setup_s

    sample = Sample(int(mix["check_calls"]), seed)
    w = window(encode, docs, seconds, sample)
    stages = stats.report() if stats is not None else {}
    events, traced_ids = [], {}
    if traced and w["error"] is None:
        events, traced_ids = traced_calls(encode, docs, w["calls"], int(mix["trace_calls"]), on_cuda)
    counters = {c: int(getattr(encoder, c)) for c in cfg["zero_counters"]}
    peak = int(torch.cuda.max_memory_allocated()) if on_cuda else 0
    kind = torch.cuda.get_device_name(0) if on_cuda else "cpu"
    del encode, encoder
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()

    # The check: the reference encodes each chosen document again.
    ref = Reference(corpus.vocab_lines)
    chosen = sample.chosen()
    chosen.update(traced_ids)
    ids_wrong = 0
    unit_cps = unit_ids = 0
    for i, got in sorted(chosen.items()):
        want, ucp, uid = ref.encode(docs.doc(i))
        n = min(want.shape[0], got.shape[0])
        ids_wrong += int(np.count_nonzero(want[:n] != got[:n])) + abs(want.shape[0] - got.shape[0])
        if i in traced_ids:
            unit_cps += ucp
            unit_ids += uid
    failed = int(w["error"] is not None)
    compared = {"ids_wrong": (ids_wrong, 0), "calls_failed": (failed, 0)}
    compared.update({name: (v, 0) for name, v in counters.items()})
    correct = all(v <= limit for v, limit in compared.values())

    dev = {"platform": "gpu" if on_cuda else "cpu", "kind": kind, "count": int(cell.workload["chips"]),
           "memory_peak_bytes": peak}
    if on_cuda:
        dev["power_limit"] = power_limit()
    info = {"calls": w["calls"], "bytes": w["bytes"], "window_s": w["seconds"],
            "call_p50_ms": float(np.median(w["lat"])) * 1e3 if w["calls"] else None,
            "calls_checked": len(chosen), "setup_s": setup_s,
            "setup_at_s": parts}
    if w["calls"]:
        info.update(e2e(w))
        tenths = np.array_split(w["lat"], 10)
        info["call_ms_by_tenth"] = [round(float(t.mean()) * 1e3, 3) for t in tenths if t.size]
    if traced:
        info["trace_calls"] = len(traced_ids)
    metrics: dict = {}
    if traced:
        records = {
            "device": kind,
            "window": {k: w[k] for k in ("calls", "bytes", "seconds")},
            "stages": stages,
            "trace": {"events": events, "calls": len(traced_ids),
                      "unit_bytes": 4 * (unit_cps + unit_ids)},
            "peaks": _load_json(PEAKS).get(kind),
        }
        for m in cell.per_layer:
            value = cell.reader(m["name"])(records)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        if events:
            dev["busy_s"] = trace.busy_us(events) * 1e-6
            dev["window_s"] = trace.window_us(events) * 1e-6
    elif w["calls"]:
        values = dict(e2e(w), setup_s=setup_s)
        if on_cuda:
            values["device_memory_peak_MB"] = peak / 1e6
        for m in cell.end_to_end:
            if m["source"] == "device_trace" and not on_cuda:
                continue  # the program's CPU path, in the benchmark's own tests
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    out = {"correct": correct, "attempted": w["calls"] + failed, "failed": failed,
           "metrics": metrics, "device": dev}
    if traced and events:
        out["breakdown"] = trace.breakdown(events)
    out["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    return {"result": out, "info": info, "error": w["error"]}


def main(args, t_start: float) -> int:
    import torch

    cell = Cell(args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{cell.name} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    res = run(cell, args.seed, args.seconds, bool(args.trace), t_start=t_start)
    bad = banned_modules(list(sys.modules))
    if bad:
        print(f"loaded in the measuring process: {', '.join(bad)}", file=sys.stderr)
        return 3
    if res["error"]:
        print(res["error"], file=sys.stderr)
    print(json.dumps(res["info"]))
    for name, c in res["result"]["compared"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res["result"]), flush=True)
    return 0

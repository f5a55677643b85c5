"""Tracing / profiling: first-class per-stage counters + torch.profiler.

The reference has essentially no observability (an unused currentTs(),
SURVEY.md §5); timing lives in its Python harness.  Here profiling is a
first-class subsystem: any encoder can be handed a `StageStats` collector
that records wall time and throughput per pipeline stage (host segment,
bucket fill, device dispatch, fetch, expand), and `trace()` wraps a region
in a torch.profiler trace (CPU and CUDA activity) for timeline inspection.

Device work is asynchronous: dispatch only enqueues it, so its time shows
up in the stage that waits for it (device_fetch).
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict


class StageStats:
    """Accumulates per-stage wall times and byte counts."""

    def __init__(self):
        self.times: dict[str, float] = defaultdict(float)
        self.calls: dict[str, int] = defaultdict(int)
        self.bytes: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, nbytes: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.times[name] += dt
            self.calls[name] += 1
            self.bytes[name] += nbytes

    def report(self) -> dict:
        out = {}
        for name, t in sorted(self.times.items()):
            entry = {"seconds": round(t, 6), "calls": self.calls[name]}
            if self.bytes[name]:
                entry["bytes"] = self.bytes[name]
                entry["bytes_per_s"] = round(self.bytes[name] / t, 1) if t > 0 else None
            out[name] = entry
        return out

    def dump(self) -> str:
        return json.dumps(self.report(), indent=2)

    def reset(self) -> None:
        self.times.clear()
        self.calls.clear()
        self.bytes.clear()


@contextlib.contextmanager
def trace(path: str | None = "trace.json"):
    """torch.profiler region over CPU and (when present) CUDA activity;
    writes a Chrome trace to `path` (unless it is None) and yields the
    profiler, whose events() and key_averages() give per-kernel times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    if path is not None:
        prof.export_chrome_trace(path)

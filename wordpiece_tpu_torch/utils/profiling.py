"""Tracing / profiling: first-class per-stage counters + torch.profiler.

The reference has essentially no observability (an unused currentTs(),
SURVEY.md §5); timing lives in its Python harness.  Here profiling is a
first-class subsystem: any encoder can be handed a `StageStats` collector
that records wall time, self time and bytes per pipeline stage (host
segment, bucket fill, device dispatch, fetch, expand) and counts units by
route, and `trace()` wraps a region in a torch.profiler trace (CPU and
CUDA activity) for timeline inspection.

Device work is asynchronous: dispatch only enqueues it, so its time shows
up in the stage that waits for it (device_fetch).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

_clock = time.perf_counter


class StageStats:
    """Accumulates per-stage wall times, self times and byte counts, and
    named counters.  Stages may run on several threads at once; a stage's
    self time is its time less that of the stages opened inside it on the
    same thread."""

    def __init__(self):
        self.times: dict[str, float] = defaultdict(float)
        self.self_times: dict[str, float] = defaultdict(float)
        self.calls: dict[str, int] = defaultdict(int)
        self.bytes: dict[str, int] = defaultdict(int)
        self.counters: dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()
        self._local = threading.local()  # .stack: nested-time cells of open stages

    @contextlib.contextmanager
    def stage(self, name: str, nbytes: int = 0):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        nested = [0.0]
        stack.append(nested)
        t0 = _clock()
        try:
            yield
        finally:
            dt = _clock() - t0
            stack.pop()
            if stack:
                stack[-1][0] += dt
            with self._lock:
                self.times[name] += dt
                self.self_times[name] += dt - nested[0]
                self.calls[name] += 1
                self.bytes[name] += nbytes

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n

    def report(self) -> dict:
        """{stage: {"seconds", "self_seconds", "calls"[, "bytes"]}, ...,
        "counters": {name: int}}."""
        with self._lock:
            out: dict = {}
            for name, t in sorted(self.times.items()):
                entry = {"seconds": round(t, 6), "self_seconds": round(self.self_times[name], 6),
                         "calls": self.calls[name]}
                if self.bytes[name]:
                    entry["bytes"] = self.bytes[name]
                out[name] = entry
            out["counters"] = {k: int(v) for k, v in sorted(self.counters.items())}
        return out

    def reset(self) -> None:
        with self._lock:
            self.times.clear()
            self.self_times.clear()
            self.calls.clear()
            self.bytes.clear()
            self.counters.clear()


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

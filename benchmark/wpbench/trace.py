"""Reduction of a torch.profiler trace (Chrome trace events) to device time.

The traced calls run inside a host span named WINDOW, each call in a
span named CALL, and each of the program's `StageStats` stages in a span
of its own name (cell.SpanStages).  Device events are kernels, copies
and memsets; their union inside the WINDOW span is the device's busy
time, the rest of the span its idle time.  Times are in microseconds, as
the trace gives them.
"""

from __future__ import annotations

from collections import defaultdict

WINDOW = "bench.window"
CALL = "bench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def window(events: list[dict]) -> tuple[float, float] | None:
    """(start, end) of the traced window's host span."""
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") == WINDOW:
            return float(e["ts"]), float(e["ts"]) + float(e["dur"])
    return None


def device_intervals(events: list[dict], cats=DEVICE_CATS) -> list[tuple[float, float, str]]:
    """(start, end, name) of the device events of `cats` inside the window,
    clipped to it, by start."""
    span = window(events)
    if span is None:
        return []
    lo, hi = span
    out = []
    for e in events:
        if e.get("cat") in cats and "dur" in e:
            s, t = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            if t > lo and s < hi:
                out.append((max(s, lo), min(t, hi), e.get("name", "?")))
    out.sort()
    return out


def _union(intervals) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for s, t, *_ in intervals:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return [(s, t) for s, t in merged]


def busy_us(events: list[dict]) -> float:
    """Microseconds of the window in which some device event ran."""
    return sum(t - s for s, t in _union(device_intervals(events)))


def window_us(events: list[dict]) -> float | None:
    span = window(events)
    return None if span is None else span[1] - span[0]


def idle_pct(events: list[dict]) -> float | None:
    """Share of the window with no kernel, copy or memset on the device;
    None where the window holds no device event."""
    span_us = window_us(events)
    busy = busy_us(events)
    if not span_us or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / span_us)


def kernel_us(events: list[dict]) -> float:
    """Device time of every kernel in the window (overlaps counted twice,
    as each kernel's own time)."""
    return sum(t - s for s, t, _ in device_intervals(events, ("kernel",)))


def count(events: list[dict], cat: str) -> int:
    return len(device_intervals(events, (cat,)))


def _host_spans(events: list[dict]) -> list[tuple[float, float, str]]:
    return [
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
        for e in events
        if e.get("cat") == "user_annotation" and e.get("name") != WINDOW and "dur" in e
    ]


def breakdown(events: list[dict], top: int = 10) -> dict:
    """The device operations that took most time (seconds, summed by
    name), and the longest idle gaps of the window, each named after the
    innermost host span around its middle (a stage, else the call, else
    the time between calls)."""
    span = window(events)
    if span is None:
        return {"device_ops": [], "idle_gaps": []}
    dev = device_intervals(events)
    by_name: dict[str, float] = defaultdict(float)
    for s, t, name in dev:
        by_name[name] += (t - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    gaps = []
    cursor = span[0]
    for s, t in _union(dev) + [(span[1], span[1])]:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, t)
    gaps.sort(key=lambda g: g[0] - g[1])
    host = _host_spans(events)
    named = []
    for s, t in gaps[:top]:
        mid = (s + t) / 2
        around = [h for h in host if h[0] <= mid <= h[1]]
        label = min(around, key=lambda h: h[1] - h[0])[2] if around else "between calls"
        named.append([label, (t - s) * 1e-6])
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}

"""A fast-stream kernel's share of its roofline in the traced calls.

The least time is the bytes the kernel must move in a call
(stream_bytes.py) at the card's memory bandwidth (peaks.json).  The time
taken a call is, for each of the kernel's names, the device time of the
trace's kernels whose (mangled) name holds it, over the traced calls, or
over its events where the trace holds fewer events than calls: each of
these kernels runs once a call, and the profiler has been seen to drop
the first kernel and memset it should record.  The call's sizes are the
program's counters over the window: `stream_positions` and
`stream_table_rows` a call, the same in every call of a cell whose
documents share one bucket."""

from __future__ import annotations

from . import trace


def call_us(events: list[dict], name: str, calls: int) -> float | None:
    """Device time a call of the window's kernels whose name holds `name`;
    None where there is none."""
    us = [t - s for s, t, n in trace.device_intervals(events, ("kernel",)) if name in n]
    return sum(us) / min(len(us), calls) if us else None


def share_pct(records: dict, names: tuple[str, ...], nbytes) -> float | None:
    """`nbytes(n, rows)`: the kernels' bytes for a call of n positions
    against a table of `rows` slots.  None without the counters, the
    card's peaks or a kernel of each name in the trace."""
    c = records["stages"].get("counters", {})
    calls = records["window"]["calls"]
    traced = records["trace"]["calls"]
    peaks = records["peaks"]
    if not (peaks and calls and traced and c.get("stream_positions")):
        return None
    times = [call_us(records["trace"]["events"], name, traced) for name in names]
    if None in times or sum(times) <= 0:
        return None
    n = c["stream_positions"] / calls
    rows = c.get("stream_table_rows", 0) / calls
    return 100.0 * nbytes(n, rows) / peaks["hbm_bytes_per_s"] / (sum(times) * 1e-6)

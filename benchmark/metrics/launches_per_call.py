"""Kernels the card ran a traced call, from the profiler's trace."""

from wpbench import trace


def read(records: dict) -> float | None:
    t = records["trace"]
    n = trace.count(t["events"], "kernel")
    return n / t["calls"] if n and t["calls"] else None

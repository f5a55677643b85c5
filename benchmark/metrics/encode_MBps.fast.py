"""Document bytes of the traced run's window over its wall time, in MB/s:
`encode_MBps` itself, kept per layer in the cells where the host's drift
leaves it too unsteady to bound (PERF.md §2)."""


def read(records: dict) -> float | None:
    w = records["window"]
    return w["bytes"] / 1e6 / w["seconds"] if w["calls"] and w["seconds"] > 0 else None

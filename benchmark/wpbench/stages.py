"""Readings of the program's StageStats over the measured window."""


def per_mb(records: dict, stage: str) -> float | None:
    """Milliseconds of `stage` a MB (10^6 bytes) of the window's documents."""
    st = records["stages"].get(stage)
    mb = records["window"]["bytes"] / 1e6
    return st["seconds"] * 1e3 / mb if st and mb else None

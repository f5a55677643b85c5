"""Share of the traced window in which no kernel, copy or memset ran on the card."""

from wpbench import trace


def read(records: dict) -> float | None:
    return trace.idle_pct(records["trace"]["events"])

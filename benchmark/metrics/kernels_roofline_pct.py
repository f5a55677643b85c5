"""The least time the card needs for the traced calls' work, over the
device time of every kernel they launched.

The work is counted from the inputs, whatever engine, kernel or routing
does it: each codepoint of a call's distinct space-separated runs read
once at 4 bytes, and each id of those runs written once at 4 bytes (the
reference counts them).  The least time is those bytes at the card's
memory bandwidth (wpbench/peaks.json)."""

from wpbench import trace


def read(records: dict) -> float | None:
    peaks = records["peaks"]
    t = records["trace"]
    kernel_s = trace.kernel_us(t["events"]) * 1e-6
    if not peaks or kernel_s <= 0 or not t["unit_bytes"]:
        return None
    return 100.0 * t["unit_bytes"] / peaks["hbm_bytes_per_s"] / kernel_s

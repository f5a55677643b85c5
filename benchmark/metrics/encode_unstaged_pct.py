"""Share of the program's `encode` stage (StageStats: the caller's thread
from the entry to the return) that no stage opened inside it on that
thread covers: its self time over its time, in %."""


def read(records: dict) -> float | None:
    st = records["stages"].get("encode")
    if not st or st["seconds"] <= 0:
        return None
    return 100.0 * st["self_seconds"] / st["seconds"]

"""Host time of the program's `host_expand` stage (StageStats) a MB of the window."""

from wpbench.stages import per_mb


def read(records: dict) -> float | None:
    return per_mb(records, "host_expand")

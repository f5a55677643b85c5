"""Host time of the program's `host_decode` stage (StageStats: UTF-8 to
codepoints, the native decoder) a MB of the window."""

from wpbench.stages import per_mb


def read(records: dict) -> float | None:
    return per_mb(records, "host_decode")

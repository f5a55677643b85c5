"""Host time of the fast-stream engine's `device_fetch` stage (StageStats:
the wait on the kernels at the id count's read, and the ids' copy back)
a MB of the window."""

from wpbench.stages import per_mb


def read(records: dict) -> float | None:
    return per_mb(records, "device_fetch")

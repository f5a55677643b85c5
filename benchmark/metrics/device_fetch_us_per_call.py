"""The program's `device_fetch` stage (StageStats: the host's wait for the
card's results, the copy back and any thread hop) a call of the window."""


def read(records: dict) -> float | None:
    st = records["stages"].get("device_fetch")
    calls = records["window"]["calls"]
    return st["seconds"] * 1e6 / calls if st and calls else None

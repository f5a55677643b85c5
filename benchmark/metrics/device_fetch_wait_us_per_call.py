"""The part of the program's `device_fetch` spent waiting on the card's
event (its `device_wait` stage), a call of the window."""


def read(records: dict) -> float | None:
    stages = records["stages"]
    calls = records["window"]["calls"]
    if "device_fetch" not in stages or "device_wait" not in stages or not calls:
        return None
    return stages["device_wait"]["seconds"] * 1e6 / calls

"""The part of the program's `device_fetch` that is neither the wait on
the card (`device_wait`) nor the host unpack (`fetch_unpack`): in fast the
fetch thread's start and hand-back, a call of the window, floored at 0."""


def read(records: dict) -> float | None:
    stages = records["stages"]
    calls = records["window"]["calls"]
    if any(s not in stages for s in ("device_fetch", "device_wait", "fetch_unpack")) or not calls:
        return None
    hop = (stages["device_fetch"]["seconds"] - stages["device_wait"]["seconds"]
           - stages["fetch_unpack"]["seconds"])
    return max(hop, 0.0) * 1e6 / calls

"""Parts the native session's scan ran a segmentation call (the program's
`segment_parts` counter over the calls of its `host_segment_dedupe`
stage); nothing for a program that does not count them."""


def read(records: dict) -> float | None:
    stages = records["stages"]
    parts = stages.get("counters", {}).get("segment_parts")
    st = stages.get("host_segment_dedupe")
    if parts is None or not st or not st["calls"]:
        return None
    return parts / st["calls"]

"""Time the caller's thread blocks on the pipeline worker (the program's
`wait_worker` stage: segmentation and, in fast, the next chunk's prepare)
a MB (10^6 bytes) of the window; 0.0 where the calls never waited (a
one-chunk call), nothing for a program without the `encode` stage."""


def read(records: dict) -> float | None:
    stages = records["stages"]
    mb = records["window"]["bytes"] / 1e6
    if "encode" not in stages or not mb:
        return None
    st = stages.get("wait_worker")
    return st["seconds"] * 1e3 / mb if st else 0.0

"""The fast-stream commit's three kernels (`commit_walk_kernel`,
`commit_emit_kernel`, `commit_fill_kernel`, csrc/commit.cu) against their
roofline: 30 n + 12 bytes a call at the card's bandwidth."""

from wpbench import rooflines, stream_bytes


def read(records: dict) -> float | None:
    return rooflines.share_pct(records, ("commit_walk_kernel", "commit_emit_kernel", "commit_fill_kernel"),
                               lambda n, rows: stream_bytes.commit_bytes(n))

"""The fast-stream probe kernel (`match_positions_kernel`, csrc/match_fast.cu)
against its roofline: 17 n + 20 rows bytes a call at the card's bandwidth."""

from wpbench import rooflines, stream_bytes


def read(records: dict) -> float | None:
    return rooflines.share_pct(records, ("match_positions_kernel",), stream_bytes.match_bytes)

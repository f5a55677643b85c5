"""The fast-stream features kernel (`text_features_kernel`, csrc/text_features.cu)
against its roofline: 20 n + 8 bytes a call at the card's bandwidth."""

from wpbench import rooflines, stream_bytes


def read(records: dict) -> float | None:
    return rooflines.share_pct(records, ("text_features_kernel",),
                               lambda n, rows: stream_bytes.features_bytes(n))

"""Host time of the fast-stream engine's staging a MB of the window: its
`host_pad` stage (the codepoints into the padded bucket) and its
`stream_h2d` stage (their copy to the card), both StageStats."""

from wpbench.stages import per_mb


def read(records: dict) -> float | None:
    pad, h2d = per_mb(records, "host_pad"), per_mb(records, "stream_h2d")
    return None if pad is None or h2d is None else pad + h2d

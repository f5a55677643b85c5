"""The bytes each kernel of the fast-stream engine must move in one call,
from its sizes alone: `n` the padded positions the kernels run
(bucket_size of the call's codepoints), `rows` the probe table's slots.
Pure arithmetic, the bytes terms of chip_smoke.py's `stream_bytes_ops`,
`features_bytes_ops` and `commit_bytes_ops`, kept with the benchmark."""


def features_bytes(n: int) -> int:
    """Bytes the features must move: the codepoints read (4 a position),
    the four flags (1 each), window (4) and ss, wnext (4 each, n + 1)
    written."""
    return 20 * n + 8


def match_bytes(n: int, rows: int) -> int:
    """Bytes the probe must move: per position its codepoint, window and
    kind read and its two outputs written (n * 17), and the table's
    20-byte rows once."""
    return 17 * n + 20 * rows


def commit_bytes(n: int) -> int:
    """Bytes the commit must move: best_id, best_len, window (4 each), ss,
    wnext (4 each, n + 1), space, wp (1 each) read; ids, positions (4
    each) and the count written."""
    return 30 * n + 12

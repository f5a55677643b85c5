"""Pieces the whole-text engine ran a call on the card (the program's
`stream_pieces` counter over the window's calls): one for a document of at
most 2^22 codepoints, more for a longer one, each piece a bucket of at most
2^22 positions on the card.  Nothing for a program that does not count
them (one that runs a document as one program whatever its length), nor
on the program's CPU path, which holds no card memory (the
`device_memory_peak_MB` it moves is not read there either)."""


def read(records: dict) -> float | None:
    pieces = records["stages"].get("counters", {}).get("stream_pieces")
    calls = records["window"]["calls"]
    if pieces is None or not calls or records["device"] == "cpu":
        return None
    return pieces / calls

"""Share of the window's document bytes that the fast-stream engine
decoded on the card (the program's `stream_card_decoded_bytes` counter
over the window's bytes), in %; nothing for a program that does not count
them (one that decodes on the host)."""


def read(records: dict) -> float | None:
    c = records["stages"].get("counters", {})
    mb = records["window"]["bytes"]
    if "stream_card_decoded_bytes" not in c or not mb:
        return None
    return 100.0 * c["stream_card_decoded_bytes"] / mb

"""Share of the window's first-seen units that the host encodes (the
program's `units_host` counter over `units_new`), in %: the small-batch
tail, units of 1-2 codepoints and units wider than the widest bucket."""


def read(records: dict) -> float | None:
    c = records["stages"].get("counters", {})
    if not c.get("units_new"):
        return None
    return 100.0 * c.get("units_host", 0) / c["units_new"]

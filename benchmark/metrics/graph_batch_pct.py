"""Share of the window's device batches that a CUDA graph's replay ran
(the program's `batches_graph` counter over it and `batches_eager`), in
%; nothing for a program that counts neither."""


def read(records: dict) -> float | None:
    c = records["stages"].get("counters", {})
    total = c.get("batches_graph", 0) + c.get("batches_eager", 0)
    return 100.0 * c.get("batches_graph", 0) / total if total else None

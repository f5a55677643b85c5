"""Host time the linear engine's caller spends enqueueing its device
batches (the program's `batch_enqueue` stage: the inputs' copies to the
card, a CUDA graph's replay or the batch's launches, the compact vector's
copy back and its event) a MB (10^6 bytes) of the window; nothing for a
program without the stage."""

from wpbench.stages import per_mb


def read(records: dict) -> float | None:
    return per_mb(records, "batch_enqueue")

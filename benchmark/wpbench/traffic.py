"""Documents of a traffic mix: slices of the seed's pool of text.

A mix's "documents" give either one size (`bytes`) or a lognormal law of
sizes (`median_bytes`, `sigma`, `min_bytes`, `max_bytes`).  The law is
cut into `sizes` fixed quantiles, and every block of that many calls
hands the encoder each of them once, in an order drawn from the seed: so
every seed sends the same sizes and only their order and text differ.
Each document starts after a space or newline of the pool at an offset
drawn from the seed and ends before the first one past its size, so no
word is cut and no two calls of a run send the same bytes.
"""

from __future__ import annotations

from statistics import NormalDist

import numpy as np

from .corpus import STREAM_DOCS, rng_for

N_DOCS = 1 << 18  # documents drawn ahead; a run that makes more calls starts again


def size_set(spec: dict) -> np.ndarray:
    """The sizes one block of calls sends, in bytes."""
    if "bytes" in spec:
        return np.array([int(spec["bytes"])], dtype=np.int64)
    q = (np.arange(int(spec["sizes"])) + 0.5) / int(spec["sizes"])
    z = np.array([NormalDist().inv_cdf(x) for x in q])
    sizes = np.exp(np.log(float(spec["median_bytes"])) + float(spec["sigma"]) * z)
    return np.clip(np.rint(sizes), int(spec["min_bytes"]), int(spec["max_bytes"])).astype(np.int64)


class Documents:
    """`doc(i)`: the i-th document of a run; `warmup()`: documents for
    set-up, at `n_warmup` sizes spread over the size set, the largest
    included, drawn apart from the run's."""

    def __init__(self, spec: dict, pool: bytes, seed: int, n_warmup: int):
        self.pool = pool
        arr = np.frombuffer(pool, dtype=np.uint8)
        self._gaps = np.flatnonzero((arr == 32) | (arr == 10))
        sizes = size_set(spec)
        rng = rng_for(seed, STREAM_DOCS)
        blocks = -(-N_DOCS // sizes.shape[0])
        order = np.argsort(rng.random((blocks, sizes.shape[0])), axis=1)
        seq = sizes[order].reshape(-1)[:N_DOCS]
        self.start, self.end = self._place(seq, rng)
        spread = np.sort(sizes)[np.linspace(0, sizes.shape[0] - 1, n_warmup).round().astype(int)]
        self._warm = self._place(spread, rng)

    def _place(self, sizes: np.ndarray, rng: np.random.Generator):
        room = len(self.pool) - int(sizes.max()) - 4096
        if room <= 0:
            raise ValueError("the pool is too small for the mix's largest document")
        start = self._next_gap(rng.integers(0, room, size=sizes.shape[0])) + 1
        return start.tolist(), self._next_gap(start + sizes).tolist()

    def _next_gap(self, at: np.ndarray) -> np.ndarray:
        """The first space or newline at or after each offset (searched in
        ascending order, which keeps the search in cache)."""
        order = np.argsort(at, kind="stable")
        out = np.empty_like(at)
        out[order] = self._gaps[np.searchsorted(self._gaps, at[order])]
        return out

    def doc(self, i: int) -> bytes:
        i %= N_DOCS
        return self.pool[self.start[i] : self.end[i]]

    def warmup(self) -> list[bytes]:
        return [self.pool[s:e] for s, e in zip(*self._warm)]

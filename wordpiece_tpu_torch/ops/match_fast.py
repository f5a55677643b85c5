"""Per-position longest match by rolling-hash table probes (fast-stream
engine): the counterpart of wordpiece_tpu/ops/match_fast.py.

Every text position probes every length 1..max_len:

  for l in 1..max_len:
      h_l[i] = h_{l-1}[i] * P + cp[i + l - 1]     (two 32-bit hashes)
      probe the open-addressing table with (h1, h2, l, kind[i])
      accept if hit and l <= window[i]; the longest l wins.

The table is built on the host (core/vocab.build_index: linear probing,
no deletions, no two entries with one (k1, k2, len, kind), an exact
probe-chain bound max_probe) and packed into int32[S, 5] rows {k1, k2,
meta, id, first codepoint}.  `load_table` carries them to a device once
as a ProbeTable in the CUDA kernel's layout: an 8-bit tag per slot (0
empty, else `tag_of(k1)`) and the rows padded to 32 bytes, whose first
five columns the plain version reads.

`match_positions_plain` is the plain PyTorch version, with the JAX
version's loops: every length, every one of max_probe slots, no early
exit.  PyTorch has no full uint32 arithmetic, so the hashes are int64
wrapped to 32 bits with `& 0xFFFFFFFF` (ops/word_kernel._mul32 for the
products) and the table's int32 words are compared in the same unsigned
view.  `match_positions` runs it for CPU tensors; for CUDA tensors it
launches the hand-written kernel csrc/match_fast.cu (ops/match_fast_cuda.py)
or raises, and counts the launch in `match_positions.launches` (and in
`match_positions.launches_global` when the kernel read its tags from
global memory).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.length_tables import KIND_MIX, LEN_MIX
from .match_fast_cuda import launch
from .word_kernel import MASK32, _mul32

TABLE_K1, TABLE_K2, TABLE_META, TABLE_ID, TABLE_FIRST = range(5)


def pack_table_np(index) -> np.ndarray:
    """VocabIndex -> int32[S, 5] host table (the JAX pack_table's rows)."""
    first = np.where(
        index.table_id >= 0,
        index.packed[np.maximum(index.table_id, 0), 0],
        -1,
    ).astype(np.int32)
    return np.stack(
        [
            index.table_k1.view(np.int32),
            index.table_k2.view(np.int32),
            index.table_meta,
            index.table_id,
            first,
        ],
        axis=1,
    )


TAG_MIX = 0x7FEB352D  # kTagMix of csrc/match_fast.cu


def tag_of(k1: torch.Tensor) -> torch.Tensor:
    """The 8-bit tag of k1 keys (int64 tensor of uint32 values), never 0:
    the top byte of k1 * TAG_MIX on 32 bits, 1 where that byte is 0.  The
    CUDA kernel computes the same tag from a probe's h1."""
    t = _mul32(k1, TAG_MIX) >> 24
    return torch.where(t == 0, 1, t)


@dataclasses.dataclass(frozen=True)
class ProbeTable:
    """The probe table on one device, in the CUDA kernel's layout.

    tags:  uint8[S], 0 for an empty slot (id < 0), else tag_of(k1);
    slots: int32[S, 8], {k1, k2, meta, id, first} then three zeros: one
           32-byte row (one L2 sector) per slot."""

    tags: torch.Tensor
    slots: torch.Tensor

    @property
    def rows(self) -> torch.Tensor:
        """int32[S, 5], the JAX pack_table's rows (a view of `slots`), which
        the plain version reads."""
        return self.slots[:, :5]

    @property
    def device(self) -> torch.device:
        return self.slots.device


def load_table(table_np, device) -> ProbeTable:
    """A packed table as numpy (this module's pack_table_np, the JAX
    pack_table's output, or one partition of a ShardedVocabIndex.tables)
    -> a ProbeTable on `device`, its tags and 32-byte rows built on the
    host and copied once."""
    table = np.array(table_np, dtype=np.int32, order="C")  # a copy the tensor owns
    if table.ndim != 2 or table.shape[1] != 5:
        raise ValueError(f"expected an int32[S, 5] table, got shape {table.shape}")
    rows = torch.from_numpy(table)
    k1 = rows[:, TABLE_K1].to(torch.int64) & MASK32
    tags = torch.where(rows[:, TABLE_ID] >= 0, tag_of(k1), 0).to(torch.uint8)
    slots = torch.zeros((table.shape[0], 8), dtype=torch.int32)
    slots[:, :5] = rows
    return ProbeTable(tags.to(device), slots.to(device))


def pack_table(index, device) -> ProbeTable:
    """VocabIndex -> ProbeTable on `device`."""
    return load_table(pack_table_np(index), device)


def _bucket(h1, h2, kind, length, log2_size: int):
    """Home slot of (h1, h2, kind, length): int64 tensors of uint32 values
    (length: an int or a tensor) in, int64 slots in [0, 2^log2_size) out.  The shift is logical on 32
    bits (the value is kept unsigned)."""
    mixed = h1 ^ ((h2 << 1) & MASK32) ^ ((length * LEN_MIX) & MASK32) ^ (kind * KIND_MIX)
    return _mul32(mixed, LEN_MIX) >> (32 - log2_size)


def probe_keys(cp_pad, wp, *, max_len: int, log2_size: int, mult1: int, mult2: int):
    """Yields, for l = 1..max_len, the probe of every position i < n at
    length l: (l, h1, h2, bucket, meta_want), int64[n] (uint32 values for
    the hashes).  n = len(wp)."""
    n = wp.shape[0]
    kind = wp.to(torch.int64)
    cp = cp_pad.to(torch.int64)
    h1 = torch.zeros(n, dtype=torch.int64, device=cp.device)
    h2 = torch.zeros(n, dtype=torch.int64, device=cp.device)
    for l in range(1, max_len + 1):
        c = cp[l - 1 : l - 1 + n]
        h1 = (_mul32(h1, mult1) + c) & MASK32
        h2 = (_mul32(h2, mult2) + c) & MASK32
        yield l, h1, h2, _bucket(h1, h2, kind, l, log2_size), (l << 1) | kind


def match_positions_plain(
    cp_pad: torch.Tensor,  # int32[n + max_len] codepoints, zero pad
    window: torch.Tensor,  # int32[n]
    wp: torch.Tensor,  # bool[n] word-prefix flag => probe kind
    table: torch.Tensor,  # int32[S, 5], rows of any stride
    *,
    max_len: int,
    max_probe: int,
    log2_size: int,
    mult1: int,
    mult2: int,
):
    """Returns (best_id int32[n], best_len int32[n]); best_len == 0 => no
    match.  Every length and every probe slot, as the JAX version."""
    n = window.shape[0]
    dev = window.device
    mask = (1 << log2_size) - 1
    first_want = cp_pad[:n].to(torch.int32)
    k1 = table[:, TABLE_K1].to(torch.int64) & MASK32
    k2 = table[:, TABLE_K2].to(torch.int64) & MASK32
    best_id = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_len = torch.zeros(n, dtype=torch.int32, device=dev)
    for l, h1, h2, bucket, meta_want in probe_keys(
        cp_pad, wp, max_len=max_len, log2_size=log2_size, mult1=mult1, mult2=mult2
    ):
        found = torch.full((n,), -1, dtype=torch.int32, device=dev)
        for p in range(max_probe):
            slot = (bucket + p) & mask
            rows = table[slot]  # int32[n, 5]
            hit = (
                (k1[slot] == h1)
                & (k2[slot] == h2)
                & (rows[:, TABLE_META] == meta_want)
                & (rows[:, TABLE_FIRST] == first_want)
            )
            found = torch.where(hit & (found < 0), rows[:, TABLE_ID], found)
        ok = (found >= 0) & (l <= window)
        best_id = torch.where(ok, found, best_id)
        best_len = torch.where(ok, l, best_len)
    return best_id, best_len


def match_positions(
    cp_pad: torch.Tensor,
    window: torch.Tensor,
    wp: torch.Tensor,
    table: ProbeTable,
    *,
    max_len: int,
    max_probe: int,
    log2_size: int,
    mult1: int,
    mult2: int,
    global_tags: bool = False,
):
    """(best_id, best_len) int32[n]: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors (one launch, counted in
    match_positions.launches); never a fallback from one to the other.
    The kernel stages the tags in shared memory where they fit;
    `global_tags` forces it to read them from global memory (the smoke
    test holds that layout against the plain version)."""
    statics = dict(
        max_len=max_len, max_probe=max_probe, log2_size=log2_size, mult1=mult1, mult2=mult2
    )
    dev = table.device
    for name, t in (("cp_pad", cp_pad), ("window", window), ("wp", wp)):
        if t.device != dev:
            raise ValueError(f"table on {dev}, {name} on {t.device}")
    if dev.type == "cpu":
        return match_positions_plain(cp_pad, window, wp, table.rows, **statics)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    best_id, best_len, mode = launch(cp_pad, window, wp, table, **statics,
                                     global_tags=global_tags)
    if mode >= 0:  # -1: n == 0, nothing launched
        match_positions.launches += 1
        match_positions.launches_global += mode
    return best_id, best_len


match_positions.launches = 0
match_positions.launches_global = 0

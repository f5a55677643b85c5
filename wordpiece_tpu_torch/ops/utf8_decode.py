"""UTF-8 bytes to the whole-text engine's padded codepoint bucket.

Semantics of core/unicode.py::decode_utf8: each invalid byte is dropped
and consumes one byte.  Under them a continuation byte never emits and no
valid sequence covers a non-continuation byte, so byte i emits exactly
when it leads a valid sequence (its length from the lead, continuation
bytes after it inside the buffer, the shortest encoding, no surrogate, no
value past U+10FFFF), a rule on bytes i..i+3 alone.  The decode is
therefore a stream compaction, in two passes:

 - `count_codepoints(data)`: the number of codepoints the bytes hold, read
   by the host, which sizes the bucket from it;
 - `write_codepoints(counted, size)`: int32[size], the codepoints, then
   zeros.

The count can also hand the host each tile's prefix (`prefixes=True`),
from which `Offsets` finds the byte where a codepoint begins and the
codepoints before a byte; it can take the count the caller already knows
(`expect`) and leave its read to a later one (`check`); and `head` turns
the count of a document into the count of its first bytes, up to a byte no
sequence continues into.  The engine's pieces (engine.py) use all three.
`lead_mask` is the rule on host bytes (numpy).

For a CPU tensor both run the plain version (decode_plain, whole-array
PyTorch ops, in the first pass); for a CUDA tensor the hand-written
kernels of csrc/utf8_decode.cu (ops/utf8_decode_cuda.py), each pass one
launch counted in its function's `.launches`; never a fallback from one to
the other.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import utf8_decode_cuda
from .cuda_build import aligned16


class Counted(NamedTuple):
    """The first pass of a decode."""

    data: torch.Tensor  # the bytes, as the second pass reads them
    n: int  # the codepoints they hold (with `expect`, the caller's count until `check`)
    state: torch.Tensor  # on a card the count's scratch; on the CPU the codepoints
    # Where the count was asked for them: (the bytes a tile, int64[tiles]:
    # the codepoints of the bytes up to the end of each tile); the kernel's
    # tiles on a card, one byte a tile on the CPU
    tiles: tuple[int, np.ndarray] | None = None
    found: torch.Tensor | None = None  # with `expect` on a card: the pinned total the count fills


def _bytes_operand(data: torch.Tensor) -> torch.Tensor:
    if data.dim() != 1 or data.dtype != torch.uint8:
        raise ValueError(f"data: expected uint8[n], got {data.dtype}{list(data.shape)}")
    if not data.is_contiguous():
        raise ValueError("data: expected a contiguous tensor")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {data.device}")
    return data


def count_codepoints(data: torch.Tensor, *, prefixes: bool = False,
                     expect: int | None = None) -> Counted:
    """data: contiguous uint8[n].  On a card one launch on the current
    stream, then a synchronisation of the stream and a read of 4 bytes
    (with `prefixes`, and the tiles' prefixes in the same read).  With
    `expect`, the codepoints the caller knows the bytes hold: on a card
    nothing waits (without `prefixes`) and `check` reads the count later;
    on the CPU a count that differs raises here."""
    data = _bytes_operand(data)
    if data.device.type == "cpu":
        cp, ok = _decode(data)
        cps = cp[ok]
        tiles = (1, torch.cumsum(ok, 0).numpy()) if prefixes else None
        return check(Counted(data, int(cps.shape[0]), cps, tiles), expect)
    if data.shape[0] == 0:  # the write reads no scratch for no bytes
        return check(Counted(data, 0, data, (1, np.zeros(0, dtype=np.int64)) if prefixes else None),
                     expect)
    data = aligned16(data)
    scratch, total, tiles = utf8_decode_cuda.count(data, prefixes=prefixes, wait=expect is None)
    count_codepoints.launches += 1
    if expect is not None and tiles is None:
        return Counted(data, expect, scratch, None, total)
    return check(Counted(data, int(total[0]), scratch, tiles), expect)


def check(counted: Counted, expect: int | None = None) -> Counted:
    """counted, once its count is known to equal `expect` (if given) and
    the codepoints the count found (`found`): raises otherwise.  On a card
    call it after a read of the device that follows the count (every read
    synchronises the stream)."""
    found = counted.n if counted.found is None else int(counted.found[0])
    if found != counted.n or (expect is not None and found != expect):
        raise RuntimeError(f"utf8 count: {found} codepoints, the caller expected "
                           f"{counted.n if expect is None else expect}")
    return counted


count_codepoints.launches = 0


def write_codepoints(counted: Counted, size: int) -> torch.Tensor:
    """int32[size] on the bytes' device: the counted codepoints, then
    zeros; size >= counted.n.  On a card one launch on the current
    stream."""
    if size < counted.n:
        raise ValueError(f"size {size} below the {counted.n} codepoints")
    if counted.data.device.type == "cpu":
        out = torch.zeros(size, dtype=torch.int32)
        out[: counted.n] = counted.state
        return out
    out = utf8_decode_cuda.write(counted.data, counted.state, counted.n, size)
    write_codepoints.launches += 1
    return out


write_codepoints.launches = 0


def head(counted: Counted, nbytes: int, n: int) -> Counted:
    """The first pass of counted.data[:nbytes] alone, from the pass over all
    of it: byte nbytes must be one that no sequence continues into (an
    ASCII byte, or a lead), so the head's bytes decode as they do in the
    whole, and n is the codepoints they hold.  On a card the same scratch:
    the write reads the prefixes of the tiles before the head's last,
    which lie wholly inside the head."""
    state = counted.state[:n] if counted.data.device.type == "cpu" else counted.state
    return Counted(counted.data[:nbytes], n, state)


class Offsets:
    """Codepoint and byte offsets of the host bytes `raw` whose count
    (count_codepoints(..., prefixes=True)) is `counted`: a tile's prefix
    places a codepoint within its tile, and the rule on that tile's bytes
    within it."""

    def __init__(self, counted: Counted, raw):
        self.tile, self.prefixes = counted.tiles
        self.raw = np.frombuffer(raw, dtype=np.uint8)

    def _tile(self, t: int) -> tuple[int, int, bool]:
        """Tile t's first byte, the codepoints before it, and whether every
        byte of it leads."""
        t0, base = t * self.tile, int(self.prefixes[t - 1]) if t else 0
        return t0, base, int(self.prefixes[t]) - base == min(self.tile, self.raw.shape[0] - t0)

    def _leads(self, lo: int, hi: int) -> np.ndarray:
        """lead_mask of raw[lo:hi], read with the bytes after it."""
        return lead_mask(self.raw[lo : hi + 3])[: hi - lo]

    def byte_of(self, k: int) -> int:
        """The byte where codepoint k (< n) begins."""
        t0, base, every = self._tile(int(np.searchsorted(self.prefixes, k, side="right")))
        if every:
            return t0 + k - base
        return t0 + int(np.flatnonzero(self._leads(t0, t0 + self.tile))[k - base])

    def codepoints_before(self, b: int) -> int:
        """The codepoints that begin before byte b (<= len(raw))."""
        if b % self.tile == 0:
            return int(self.prefixes[b // self.tile - 1]) if b else 0
        t0, base, every = self._tile(b // self.tile)
        return base + (b - t0 if every else int(self._leads(t0, b).sum()))


def _rule(b, b1, b2, b3):
    """Byte b followed by b1, b2, b3 (int32 arrays, torch or numpy): the
    masks of the valid 1- to 4-byte sequences it leads and the 2- to
    4-byte values."""
    c1, c2, c3 = ((x & 0xC0) == 0x80 for x in (b1, b2, b3))
    cp2 = ((b & 0x1F) << 6) | (b1 & 0x3F)
    cp3 = ((b & 0x0F) << 12) | ((b1 & 0x3F) << 6) | (b2 & 0x3F)
    cp4 = ((b & 0x07) << 18) | ((b1 & 0x3F) << 12) | ((b2 & 0x3F) << 6) | (b3 & 0x3F)
    ok1 = b < 0x80
    ok2 = ((b & 0xE0) == 0xC0) & c1 & (cp2 >= 0x80)
    ok3 = ((b & 0xF0) == 0xE0) & c1 & c2 & (cp3 >= 0x800) & ((cp3 < 0xD800) | (cp3 > 0xDFFF))
    ok4 = ((b & 0xF8) == 0xF0) & c1 & c2 & c3 & (cp4 >= 0x10000) & (cp4 < 0x110000)
    return (ok1, ok2, ok3, ok4), (cp2, cp3, cp4)


def _shifted(data):
    """The bytes as int32 and the three after each; past the end 0, which
    continues nothing."""
    if isinstance(data, np.ndarray):
        b = data.astype(np.int32)
        ahead = np.concatenate([b, np.zeros(3, dtype=np.int32)])
    else:
        b = data.to(torch.int32)
        ahead = torch.cat([b, b.new_zeros(3)])
    n = b.shape[0]
    return (b,) + tuple(ahead[k : k + n] for k in (1, 2, 3))


def lead_mask(data):
    """Whether each byte of `data` (uint8, a torch tensor or a numpy
    array; the bytes after it, where they matter, included) leads a valid
    sequence, i.e. emits a codepoint."""
    ok1, ok2, ok3, ok4 = _rule(*_shifted(data))[0]
    return ok1 | ok2 | ok3 | ok4


def _decode(data: torch.Tensor):
    """(int32: the value of the sequence each byte leads, where it leads
    one; lead_mask(data))."""
    b, b1, b2, b3 = _shifted(data)
    (ok1, ok2, ok3, ok4), (cp2, cp3, cp4) = _rule(b, b1, b2, b3)
    cp = torch.where(ok2, cp2, torch.where(ok3, cp3, torch.where(ok4, cp4, b)))
    return cp, ok1 | ok2 | ok3 | ok4


def decode_plain(data: torch.Tensor) -> torch.Tensor:
    """int32 codepoints of the uint8 bytes `data`, by the rule above: the
    CPU's version, and what the kernels are held to on the card.  Past the
    end the bytes read as 0, which continues nothing."""
    cp, ok = _decode(data)
    return cp[ok]

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

For a CPU tensor both run the plain version (decode_plain, whole-array
PyTorch ops, in the first pass); for a CUDA tensor the hand-written
kernels of csrc/utf8_decode.cu (ops/utf8_decode_cuda.py), each pass one
launch counted in its function's `.launches`; never a fallback from one to
the other.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import utf8_decode_cuda
from .cuda_build import aligned16


class Counted(NamedTuple):
    """The first pass of a decode."""

    data: torch.Tensor  # the bytes, as the second pass reads them
    n: int  # the codepoints they hold
    state: torch.Tensor  # on a card the count's scratch; on the CPU the codepoints


def _bytes_operand(data: torch.Tensor) -> torch.Tensor:
    if data.dim() != 1 or data.dtype != torch.uint8:
        raise ValueError(f"data: expected uint8[n], got {data.dtype}{list(data.shape)}")
    if not data.is_contiguous():
        raise ValueError("data: expected a contiguous tensor")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {data.device}")
    return data


def count_codepoints(data: torch.Tensor) -> Counted:
    """data: contiguous uint8[n].  On a card one launch on the current
    stream, then a synchronisation of the stream and a read of 4 bytes."""
    data = _bytes_operand(data)
    if data.device.type == "cpu":
        cps = decode_plain(data)
        return Counted(data, int(cps.shape[0]), cps)
    if data.shape[0] == 0:
        return Counted(data, 0, data)  # the write reads no scratch for no bytes
    data = aligned16(data)
    scratch, n = utf8_decode_cuda.count(data)
    count_codepoints.launches += 1
    return Counted(data, n, scratch)


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


def decode_plain(data: torch.Tensor) -> torch.Tensor:
    """int32 codepoints of the uint8 bytes `data`, by the rule above: the
    CPU's version, and what the kernels are held to on the card.  Past the
    end the bytes read as 0, which continues nothing."""
    b = data.to(torch.int32)
    n = b.shape[0]
    ahead = torch.cat([b, b.new_zeros(3)])
    b1, b2, b3 = (ahead[k : k + n] for k in (1, 2, 3))
    c1, c2, c3 = ((x & 0xC0) == 0x80 for x in (b1, b2, b3))
    cp2 = ((b & 0x1F) << 6) | (b1 & 0x3F)
    cp3 = ((b & 0x0F) << 12) | ((b1 & 0x3F) << 6) | (b2 & 0x3F)
    cp4 = ((b & 0x07) << 18) | ((b1 & 0x3F) << 12) | ((b2 & 0x3F) << 6) | (b3 & 0x3F)
    ok1 = b < 0x80
    ok2 = ((b & 0xE0) == 0xC0) & c1 & (cp2 >= 0x80)
    ok3 = ((b & 0xF0) == 0xE0) & c1 & c2 & (cp3 >= 0x800) & ((cp3 < 0xD800) | (cp3 > 0xDFFF))
    ok4 = ((b & 0xF8) == 0xF0) & c1 & c2 & c3 & (cp4 >= 0x10000) & (cp4 < 0x110000)
    cp = torch.where(ok2, cp2, torch.where(ok3, cp3, torch.where(ok4, cp4, b)))
    return cp[ok1 | ok2 | ok3 | ok4]

"""Character classes on torch tensors (utf8.cpp:10-29 semantics).

The elementwise classifiers the word kernel's plain version uses; the
CUDA kernel (csrc/word_kernel.cu) carries the same definitions.  Each
takes an integer tensor of codepoints and returns a bool tensor of the
same shape.
"""

from __future__ import annotations

import torch

from ..core import unicode as uni


def is_space(cp: torch.Tensor) -> torch.Tensor:
    return (cp == 32) | ((cp >= 9) & (cp <= 13)) | (cp == uni.SPACE_TOKEN)


def is_punct(cp: torch.Tensor) -> torch.Tensor:
    ascii_punct = (
        ((cp >= 33) & (cp <= 47))
        | ((cp >= 58) & (cp <= 64))
        | ((cp >= 91) & (cp <= 96))
        | ((cp >= 123) & (cp <= 126))
    )
    extra = (cp == 183) | (cp == 171) | (cp == 187) | (cp == 8249) | (cp == 8250)
    dash = (cp >= 8208) & (cp <= 8248)
    return ascii_punct | extra | dash


def is_chinese(cp: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(cp.shape, dtype=torch.bool, device=cp.device)
    for lo, hi in uni._CHINESE_RANGES:
        out = out | ((cp >= lo) & (cp <= hi))
    return out

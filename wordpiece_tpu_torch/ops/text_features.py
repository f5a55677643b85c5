"""Character classes and per-position text features on torch tensors.

The classifiers (utf8.cpp:10-29 semantics) are the ones the word kernel's
plain version uses; the CUDA kernels carry the same definitions
(csrc/word_kernel.cu its own copy, csrc/text_features.cu those of
csrc/classify.cuh).  Each takes an integer tensor of codepoints and returns a
bool tensor of the same shape.

`compute_features` gives the position-wise quantities that drive the
linear engine's matching and the shared greedy commit (ops/commit.py):

 - ``space/punct/spacing`` flags;
 - ``wp``: is_word_prefix[i] = (i==0) | spacing[i] | spacing[i-1]
   (src/fast.cpp:38-41);
 - ``window``: the probe window at i = the reference's ``word_len`` scan
   result (src/fast.cpp:53-60): 1 for punctuation, else
   min(max_len, n_valid - i, distance to the next spacing char after i);
 - next-position helpers ``ss`` (skip spaces) and ``wnext`` (next word
   prefix), both length n+1 with sentinel n, used by the commit step.

Padding positions (i >= n_valid) are treated as spaces, so they are
skipped and never emit.

`compute_features` runs its plain version (compute_features_plain) for
a CPU tensor and the hand-written CUDA kernel csrc/text_features.cu
(ops/text_features_cuda.py: one launch, counted in
compute_features.launches unless a CUDA graph's capture records it)
for a CUDA tensor; never a fallback from one
to the other.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import unicode as uni
from . import text_features_cuda


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


@dataclasses.dataclass
class TextFeatures:
    space: torch.Tensor  # bool[n], pad => True
    punct: torch.Tensor  # bool[n]
    spacing: torch.Tensor  # bool[n], pad => True
    wp: torch.Tensor  # bool[n] is_word_prefix
    window: torch.Tensor  # int32[n] probe window (>=1)
    ss: torch.Tensor  # int32[n+1] next non-space index at-or-after (sentinel n)
    wnext: torch.Tensor  # int32[n+1] next word-prefix index at-or-after (sentinel n)


def _next_at_or_after(flag: torch.Tensor, n: int) -> torch.Tensor:
    """int32[n+1]: for each i, min{j >= i : flag[j]} else n (sentinel)."""
    pos = torch.arange(n, dtype=torch.int32, device=flag.device)
    vals = torch.where(flag, pos, n)
    nxt = torch.flip(torch.cummin(torch.flip(vals, [0]), 0).values, [0])
    return torch.cat([nxt, nxt.new_full((1,), n)])


def compute_features(cp: torch.Tensor, n_valid: int, max_len: int) -> TextFeatures:
    """cp: int[n] codepoints (garbage beyond n_valid), taken as contiguous
    int32; n_valid: the true length, a host int.  The plain version for a
    CPU tensor, the CUDA kernel for a CUDA tensor."""
    integer = not (cp.dtype.is_floating_point or cp.dtype.is_complex or cp.dtype == torch.bool)
    if cp.dim() != 1 or not integer:
        raise ValueError(f"cp: expected a 1-D integer tensor, got {cp.dtype}{list(cp.shape)}")
    if int(n_valid) < 0 or int(max_len) < 0:
        raise ValueError(f"n_valid {n_valid}, max_len {max_len}")
    cp = cp.to(torch.int32).contiguous()
    if cp.device.type == "cpu":
        return compute_features_plain(cp, int(n_valid), int(max_len))
    if cp.device.type != "cuda":
        raise ValueError(f"unsupported device {cp.device}")
    feats = TextFeatures(**text_features_cuda.launch(cp, int(n_valid), int(max_len)))
    if not torch.cuda.is_current_stream_capturing():  # a capture launches nothing
        compute_features.launches += 1
    return feats


compute_features.launches = 0


def compute_features_plain(cp: torch.Tensor, n_valid: int, max_len: int) -> TextFeatures:
    """compute_features in PyTorch ops: the CPU's version, and what the
    kernel is held to on the card."""
    n = cp.shape[0]
    pos = torch.arange(n, dtype=torch.int32, device=cp.device)
    pad = pos >= n_valid

    space = is_space(cp) | pad
    punct = is_punct(cp) & ~pad
    spacing = space | punct | is_chinese(cp) | pad

    prev_spacing = torch.cat([spacing.new_zeros(1), spacing[:-1]])
    wp = (pos == 0) | spacing | prev_spacing

    # nsp[i+1] is the first spacing index >= i+1, i.e. strictly after i:
    # the word_len scan checks text[i+k] for k >= 1 (src/fast.cpp:56-59).
    nsp = _next_at_or_after(spacing, n)
    dist = nsp[1:] - pos

    window = torch.clamp(n_valid - pos, max=max_len)
    window = torch.minimum(window, dist)
    window = torch.where(punct, 1, window)
    window = torch.clamp(window, min=1).to(torch.int32)

    ss = _next_at_or_after(~space, n)
    wnext = _next_at_or_after(wp, n)
    return TextFeatures(
        space=space, punct=punct, spacing=spacing, wp=wp, window=window, ss=ss, wnext=wnext
    )

"""Golden scalar oracle: exact reference semantics, used only by tests.

This is a direct, scalar implementation of the reference's greedy MaxMatch
worker loop (src/fast.cpp:43-99) including whole-word UNK rollback.  The
TPU engines must produce byte-identical id streams to this oracle; the
differential test suite (tests/test_differential.py) asserts that, echoing
the reference's own linear==fast oracle strategy (tests/tests.cpp:90-97).

Deliberately unoptimized Python; the production host fallback lives in the
native runtime (runtime/native).
"""

from __future__ import annotations

import numpy as np

from . import unicode as uni
from .vocab import Vocabulary


def encode_oracle(text_codepoints: np.ndarray, vocab: Vocabulary) -> list[int]:
    """Greedy MaxMatch over a codepoint array; returns the token id list."""
    text = np.asarray(text_codepoints, dtype=np.uint32)
    n = int(text.shape[0])
    if n == 0:
        return []

    # Build the prefix/suffix string maps (src/fast.cpp:21-36).
    prefix_to_id: dict[tuple, int] = {}
    suffix_to_id: dict[tuple, int] = {}
    max_len = 0
    for i in range(vocab.size):
        if vocab.is_special[i] or vocab.is_malformed[i]:
            continue
        w = tuple(int(c) for c in vocab.word(i))
        max_len = max(max_len, len(w))
        (prefix_to_id if vocab.is_prefix[i] else suffix_to_id)[w] = i
    max_len = min(max_len, n)

    space = uni.is_space(text)
    punct = uni.is_punctuation(text)
    spacing = uni.is_spacing_char(text)

    def is_word_prefix(i: int) -> bool:
        return i == 0 or bool(spacing[i]) or bool(spacing[i - 1])

    unk = vocab.unk_token_id
    ids: list[int] = []
    begin, end = 0, n

    while begin != end and space[begin]:
        begin += 1

    tokens_since_prefix = 0
    while begin != end:
        word_len = 1
        if not punct[begin]:
            while word_len < min(max_len, end - begin) and not spacing[begin + word_len]:
                word_len += 1

        table = prefix_to_id if is_word_prefix(begin) else suffix_to_id
        matched = 0
        for ln in range(word_len, 0, -1):
            key = tuple(int(c) for c in text[begin : begin + ln])
            if key in table:
                tokens_since_prefix += 1
                ids.append(table[key])
                begin += ln
                matched = ln
                break

        if matched == 0:
            while tokens_since_prefix > 0:
                ids.pop()
                tokens_since_prefix -= 1
            ids.append(unk)
            begin += word_len
            while begin != end and not is_word_prefix(begin):
                begin += 1
        elif begin != end and is_word_prefix(begin):
            tokens_since_prefix = 0

        while begin != end and space[begin]:
            begin += 1

    return ids


def encode_oracle_str(text: str | bytes, vocab: Vocabulary) -> list[int]:
    raw = text.encode("utf-8") if isinstance(text, str) else text
    return encode_oracle(uni.decode_utf8(raw), vocab)

"""The plain reference: WordPiece as gleb-kov/wordpiece defines it, in Python.

Greedy longest-match-first over each word with whole-word [UNK]
rollback (the reference's `src/fast.cpp` worker loop), the reference's
vocabulary rules (`src/utils.cpp`) and character classes
(`src/third_party/utf8.cpp`), written out again here from those sources.
It imports nothing of the program, and works from the document's bytes
and the vocab's lines alone.

The loop never crosses a space and starts afresh after one, so the ids of
a document are the ids of its space-separated runs in order: each distinct
run is encoded once and the stream is expanded from the run ids.  Inside a
run it starts afresh at every other spacing character too (punctuation, a
CJK ideograph: no match, [UNK] skip or rollback crosses into one), so a run
is the concatenation of its segments, each a spacing character with the
non-spacing ones after it, and each distinct segment is encoded once.
"""

from __future__ import annotations

import itertools
import re

import numpy as np

# isspace in the C locale, and U+2581 (utf8.cpp:10-12).
SPACES = "\t\n\x0b\x0c\r \u2581"
_RUN = re.compile("[^" + re.escape(SPACES) + "]+")
# ispunct in the C locale, and the extra marks of utf8.cpp:14-17.
_PUNCT = frozenset(
    [*range(33, 48), *range(58, 65), *range(91, 97), *range(123, 127),
     183, 171, 187, 8249, 8250, *range(8208, 8249)]
)
_CHINESE = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
            (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))


_PUNCT_CLASS = "".join(re.escape(chr(c)) for c in sorted(_PUNCT))
_CJK_CLASS = "".join(f"{chr(lo)}-{chr(hi)}" for lo, hi in _CHINESE)
# A segment of a run: a spacing character and the non-spacing ones after
# it, or the non-spacing characters that open the run.
_SEGMENT = re.compile(f"[{_PUNCT_CLASS}{_CJK_CLASS}][^{_PUNCT_CLASS}{_CJK_CLASS}]*"
                      f"|[^{_PUNCT_CLASS}{_CJK_CLASS}]+")


def classes(cps: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(space, spacing) masks of an array of codepoints: a space, and a
    space, a punctuation mark or a CJK ideograph (`is_spacing`)."""
    space = np.isin(cps, [ord(c) for c in SPACES])
    spacing = space | np.isin(cps, list(_PUNCT))
    for lo, hi in _CHINESE:
        spacing |= (cps >= lo) & (cps <= hi)
    return space, spacing


def is_punct(ch: str) -> bool:
    return ord(ch) in _PUNCT


def is_spacing(ch: str) -> bool:
    """Space, punctuation or a CJK ideograph: a word boundary."""
    cp = ord(ch)
    return ch in SPACES or cp in _PUNCT or any(lo <= cp <= hi for lo, hi in _CHINESE)


def decode(data: bytes) -> str:
    """UTF-8 as the reference decodes it: an invalid byte is dropped and
    decoding goes on at the next byte (utf8.cpp:130-147)."""
    return data.decode("utf-8", errors="ignore")


class Reference:
    """The reference encoder of one vocabulary.

    `longest_match` caps the codepoints a match may span below the vocab's
    longest token: that is the control, which breaks the guarantee that
    every match is the longest piece in the vocab."""

    def __init__(self, vocab_lines: list[str], *, longest_match: int | None = None):
        self.prefix: dict[str, int] = {}
        self.suffix: dict[str, int] = {}
        self.unk = -1
        self.max_len = 0
        for i, line in enumerate(vocab_lines):
            raw = line.encode("utf-8") if isinstance(line, str) else bytes(line)
            if raw == b"[UNK]":
                self.unk = i
            text = decode(raw)
            invalid = len(text.encode("utf-8")) != len(raw)
            cont = len(text) >= 2 and text.startswith("##")
            special = not cont and len(text) > 2 and text[0] == "[" and text[-1] == "]"
            word = text[2:] if cont else text
            if not word:
                raise ValueError(f"vocab line {i}: empty word")
            all_marks = all(is_punct(c) or c in SPACES for c in word)
            if special or invalid or (all_marks and len(word) > 1):
                continue
            (self.suffix if cont else self.prefix)[word] = i  # the last line wins
            self.max_len = max(self.max_len, len(word))
        self.longest = self.max_len if longest_match is None else min(self.max_len, longest_match)
        self._spacing: dict[str, bool] = {}
        self._segments: dict[str, list[int]] = {}

    def encode_run(self, w: str) -> list[int]:
        """The ids of one run of non-space characters, segment by segment."""
        done = self._segments
        ids: list[int] = []
        for seg in _SEGMENT.findall(w):
            got = done.get(seg)
            if got is None:
                got = done[seg] = self.encode_segment(seg)
            ids += got
        return ids

    def encode_segment(self, w: str) -> list[int]:
        """The ids of a run of non-space characters, by the loop itself."""
        spacing = self._spacing
        for c in w:
            if c not in spacing:
                spacing[c] = is_spacing(c)
        sp = [spacing[c] for c in w]
        n = len(w)
        ids: list[int] = []
        begin = 0
        since_prefix = 0  # tokens of the current word, rolled back on a miss
        while begin < n:
            word_len = 1
            if not is_punct(w[begin]):
                lim = min(self.longest, n - begin)
                while word_len < lim and not sp[begin + word_len]:
                    word_len += 1
            at_prefix = begin == 0 or sp[begin] or sp[begin - 1]
            table = self.prefix if at_prefix else self.suffix
            for ln in range(word_len, 0, -1):
                tid = table.get(w[begin : begin + ln])
                if tid is not None:
                    break
            else:
                if since_prefix:
                    del ids[-since_prefix:]
                    since_prefix = 0
                ids.append(self.unk)
                begin += word_len
                while begin < n and not (sp[begin] or sp[begin - 1]):
                    begin += 1
                continue
            ids.append(tid)
            since_prefix += 1
            begin += ln
            if begin < n and (sp[begin] or sp[begin - 1]):
                since_prefix = 0
        return ids

    def encode(self, doc: bytes) -> tuple[np.ndarray, int, int]:
        """(the ids of `doc` as int32, the codepoints of its distinct runs,
        the ids of its distinct runs): the last two are the work a call
        cannot avoid, which the roofline counts."""
        runs = _RUN.findall(decode(doc))
        uid: dict[str, int] = {}
        occ = np.fromiter((uid.setdefault(r, len(uid)) for r in runs), np.int64, len(runs))
        enc = [self.encode_run(r) for r in uid]
        counts = np.fromiter(map(len, enc), np.int64, len(enc))
        flat = np.fromiter(itertools.chain.from_iterable(enc), np.int32, int(counts.sum()))
        offs = np.zeros(len(enc) + 1, np.int64)
        np.cumsum(counts, out=offs[1:])
        c = counts[occ]
        at = np.cumsum(c) - c
        idx = np.repeat(offs[:-1][occ] - at, c) + np.arange(int(c.sum()))
        return flat[idx], sum(map(len, uid)), int(flat.shape[0])

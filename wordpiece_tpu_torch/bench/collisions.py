"""A vocabulary built to force the fingerprint collisions of the word
kernels' longest-first probe, and their count.

The match kernels (csrc/word_kernel.cu) scan a position's lengths longest
first over 16-bit fingerprints of the k1 keys and confirm only the longest
length whose list holds the fingerprint; a fingerprint that matches with
full keys that differ (a collision) sends the kernel on to the next
longest length.  `collision_vocab` adds tokens, found by a search over
random strings, that cause such collisions on given unit matrices, so that
this fallback is exercised on purpose; `fp_collisions` counts them with
the plain version's keys (ops/word_kernel.probe_keys)."""

from __future__ import annotations

import numpy as np
import torch

from ..core.length_tables import LANES, build_length_tables, fold_key2, lane_of, load_length_tables
from ..core.vocab import parse_vocab
from ..ops.word_kernel import _features, _widen, probe_keys, word_match


def fp_collisions(cps, tabs) -> tuple[int, int]:
    """The fingerprint collisions a longest-first probe meets on these
    inputs against `tabs`: the (position, length) pairs inside the window
    and longer than the position's true longest hit whose (length, lane)
    list holds the key's 16-bit fingerprint (core/length_tables.py::
    fingerprint), and the positions with at least one such pair, which the
    match kernel resolves by falling back to a shorter length."""
    dev = tabs.slot_off.device
    slots = torch.arange(tabs.n_slots, device=dev)
    lists = torch.searchsorted(tabs.slot_off.long(), slots, right=True) - 1
    held = torch.unique(lists * 65536 + (tabs.slot_fp.long() & 0xFFFF))
    kw = {k: v for k, v in tabs.statics.items() if k != "unk_id"}
    pairs = positions = 0
    for cp in cps:
        w = int(cp.shape[1])
        wide = _widen(cp, w, tabs.max_len)
        _, _, _, wp, window = _features(wide, w, tabs.max_len)
        _, best = word_match(cp, tabs.k1, tabs.k2, tabs.tid, width=w, **kw)
        met = torch.zeros_like(best, dtype=torch.bool)
        for l, h1, _, lane, in_window in probe_keys(wide, wp, window, width=w, **kw):
            key = (l * LANES + lane) * 65536 + ((h1 ^ (h1 >> 16)) & 0xFFFF)
            hit = in_window & (l > best) & torch.isin(key, held)
            pairs += int(hit.sum())
            met |= hit
        positions += int(met.sum())
    return pairs, positions


def collision_vocab(lines: list, cps, rng, *, n_tokens: int = 48, rounds: int = 4):
    """`lines` plus tokens from a search over random strings, each sharing
    (length, kind, lane, 16-bit fingerprint) with an in-window query of
    `cps` longer than the query's true longest hit, with full keys that
    differ, so the longest-first match must fall back past it.  A length's
    lane salt is chosen from that length's tokens when the tables are
    built, so the search reruns on the rebuilt tables until they hold a
    collision.  Returns (lines, device tables, (pairs, positions) of
    fp_collisions)."""
    dev = cps[0].device
    extra: list = []
    for round_ in range(rounds):
        host = build_length_tables(parse_vocab(lines + extra))
        tabs = load_length_tables(host, dev)
        if extra:
            found = fp_collisions(cps, tabs)
            if found[0]:
                return lines + extra, tabs, found
        # The queries: (length, kind, lane, fingerprint) -> their full keys.
        kw = {k: v for k, v in tabs.statics.items() if k != "unk_id"}
        queries: dict = {}
        for cp in cps:
            w = int(cp.shape[1])
            wide = _widen(cp, w, tabs.max_len)
            _, _, _, wp, window = _features(wide, w, tabs.max_len)
            _, best = word_match(cp, tabs.k1, tabs.k2, tabs.tid, width=w, **kw)
            for l, h1, key2, lane, in_window in probe_keys(wide, wp, window, width=w, **kw):
                sel = in_window & (l > best)
                code = ((((l * 2 + wp.long()) * LANES + lane) << 16) | ((h1 ^ (h1 >> 16)) & 0xFFFF))
                queries.update(zip(code[sel].tolist(), ((h1 << 32) | key2)[sel].tolist()))
        codes = np.fromiter(queries, dtype=np.int64)
        if not codes.size:
            raise AssertionError("no in-window query is longer than its longest hit")
        lengths = sorted({int(c >> 16) // (2 * LANES) for c in codes.tolist()})
        per = -(-n_tokens // (2 * len(lengths)))
        for l in lengths:
            for kind in (0, 1):
                s = rng.integers(97, 123, size=(1 << 18, l)).astype(np.uint32)
                h1 = np.zeros(s.shape[0], np.uint32)
                h2 = np.zeros(s.shape[0], np.uint32)
                with np.errstate(over="ignore"):
                    for i in range(l):
                        h1 = h1 * np.uint32(host.mult1) + s[:, i]
                        h2 = h2 * np.uint32(host.mult2) + s[:, i]
                lane = lane_of(h1, h2, l, kind, int(host.lane_salts[l])).astype(np.int64)
                code = (((l * 2 + kind) * LANES + lane) << 16) | ((h1 ^ (h1 >> np.uint32(16)))
                                                                  & np.uint32(0xFFFF)).astype(np.int64)
                full = (h1.astype(np.int64) << 32) | fold_key2(h2, l, kind).astype(np.int64)
                got = 0
                for i in np.nonzero(np.isin(code, codes))[0].tolist():
                    if queries[int(code[i])] != int(full[i]):  # not the query's own string
                        word = "".join(map(chr, s[i].tolist()))
                        extra.append(word if kind else "##" + word)
                        got += 1
                        if got == per:
                            break
        extra = sorted(set(extra) - set(lines))
    raise AssertionError(f"no fingerprint collision after {rounds} rounds of search")

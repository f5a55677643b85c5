#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (wordpiece_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (sm_90a),
nvcc and a C++ toolchain.  Imports torch and the port, never jax or the
JAX package.  Phases, each fatal on failure:

 1. the card: name and power limit from nvidia-smi;
 2. build: nvcc compiles csrc/word_kernel.cu (the match+commit kernel and
    the compaction kernel, one library); ptxas' registers, shared memory
    and spills are printed;
 3. kernels vs plain: on the card, on the same unit matrices (random ASCII,
    multilingual, astral-plane, UNK-heavy, empty rows; a row count that
    ends in a partial tile) at widths 7/15/31/127 with the bert-shaped
    vocab, the match+commit kernel equals its plain PyTorch version, once
    with the keys staged in shared memory and once with the global-key
    layout forced; the five matrices of a width go through one dispatch
    whose compact vector (compaction kernel) must equal the plain
    compaction (compact_emits), with a cap above and below the total (the
    overflow keeps the true total, whole counts and the emit matrices);
    then one dispatch of all four widths in mixed dtypes and an empty
    bucket, in both key layouts.  Integers: tolerance exactly 0;
 4. main path: every kernel's launch count is set to 0, then the fast
    engine encodes 10 MB en/ru/ja/zh corpora on the bert-shaped vocab
    through the user entry points (ids must equal the native oracle), 3 MB
    of en on a char-level vocab (past the compact cap: the full-emit
    fetch) and every tests/golden/*.npz stream (byte-identical); both
    kernels must have launched once per dispatch, and device_fallbacks
    and verify_repairs must be 0;
 5. numbers: at the first dispatch's bucket shapes of each of en/ru/ja/zh,
    both kernels are held equal to their plain versions again, then timed
    by CUDA events (the kernels behind a spin kernel, so that the events
    time the card and not the host's enqueue), beside their plain
    versions, torch.masked_select (the one PyTorch call that computes the
    compaction) and each kernel's bound; the 10 MB en encode rate (min and
    median of 5) with its stage breakdown, and one more such encode under
    torch.profiler: device time per kernel and the card's busy share of
    the wall time (--trace PATH also writes its trace).

Prints JSON lines, then the kernels line, then the card line, and last
{"ok": true, "device": {...}}.  Exits non-zero, with no result line,
without a CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet), for the kernel's bound.
HBM_BYTES_PER_S = 3.35e12
# The kernel's work is 32-bit integer compares and hashes on the CUDA
# cores; the data sheet lists no int32 rate, so its non-tensor float32
# rate stands in for it.
CORE_OPS_PER_S = 67e12


def emit_json(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() in ms by CUDA events, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float:
    """Mean device time of fn() in ms by CUDA events, for calls whose host
    side (Python, ctypes, allocation) takes longer than their kernels: a
    spin kernel holds the card while the host enqueues every call, so the
    events bracket the card's work alone.  Raises if the spin ran out
    before the host had enqueued the last call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spin = torch.cuda.Event()
    # Cycles at <= 2 GHz: the spin outlasts 4x the measured enqueue time.
    torch.cuda._sleep(int(2e9 * 4 * iters * max(enqueue_s, 20e-6)))
    spin.record()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    if spin.query():
        raise RuntimeError("device_ms: the host did not stay ahead of the card")
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, trace_path):
    """Run fn() once under torch.profiler.  Returns (wall seconds, device
    time per kernel name as [name, count, us] rows, the union of all
    device intervals in us or None when the profiler saw no device
    activity)."""
    import torch
    from torch.autograd import DeviceType

    from wordpiece_tpu_torch.utils.profiling import trace

    torch.cuda.synchronize()
    with trace(trace_path) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        count, total = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (count + 1, total + us)
        spans.append((e.time_range.start, e.time_range.end))
    if not spans:
        return wall, [], None
    busy, end = 0.0, float("-inf")
    for s, t in sorted(spans):
        if t > end:
            busy += t - max(s, end)
            end = t
    rows = sorted(([n[:80], c, us] for n, (c, us) in by_name.items()), key=lambda r: -r[2])
    return wall, rows, busy


# ---- phase 3 inputs ------------------------------------------------------
def unit_matrices(width: int, words: list[str], rng, n: int = 2061) -> dict:
    """Five int32[n, width] unit matrices (pad 32), from a fixed seed.  n is
    odd, so every width's last block of units is a partial one."""
    import numpy as np

    ascii_punct = [",", ".", "!", "-", "'", "(", ")", ";"]
    punct = ascii_punct + ["«", "»", "·", "‐", "‹"]
    cyr = [chr(c) for c in range(0x430, 0x450)]
    cjk = [chr(int(c)) for c in rng.integers(0x4E00, 0xA000, size=64)]
    kana = [chr(int(c)) for c in rng.integers(0x3041, 0x30F7, size=64)]
    astral = [chr(int(c)) for c in rng.integers(0x20000, 0x2A6E0, size=32)]
    rare = [chr(int(c)) for c in rng.integers(0x100, 0x250, size=64)]
    ascii_ = [chr(c) for c in range(33, 127)]

    def text_row(length: int) -> str:
        s = ""
        while len(s) < length:
            s += words[int(rng.integers(len(words)))]
            if rng.random() < 0.3:
                s += ascii_punct[int(rng.integers(len(ascii_punct)))]
        return s[:length]

    def pool_row(length: int, pools) -> str:
        out = []
        for _ in range(length):
            pool = pools[int(rng.integers(len(pools)))]
            out.append(pool[int(rng.integers(len(pool)))])
        return "".join(out)

    def fill(make) -> np.ndarray:
        m = np.full((n, width), 32, dtype=np.int32)
        for i in range(n):
            s = make(int(rng.integers(1, width + 1)), i)
            cps = [ord(c) for c in s][:width]
            m[i, : len(cps)] = cps
        return m

    multi = [cyr, cjk, kana, punct, ["\t", "▁"], ascii_]
    return {
        "ascii": fill(
            lambda L, i: text_row(L) if i % 2 else pool_row(L, [ascii_])
        ),
        "multilingual": fill(lambda L, i: pool_row(L, multi)),
        "astral": fill(lambda L, i: pool_row(L, multi + [astral])),
        "unk_heavy": fill(
            lambda L, i: "".join(
                c if rng.random() < 0.8 else rare[int(rng.integers(len(rare)))]
                for c in text_row(L)
            )
        ),
        "empty_rows": fill(lambda L, i: text_row(L) if i % 3 == 0 else ""),
    }


def kernel_bytes_ops(cps, tables) -> tuple[int, int]:
    """Bytes one match+commit dispatch must move and the integer operations
    it must do on these inputs.  Bytes: the units, the list offsets, every
    occupied slot's {k1, k2, tid} (12 bytes) and the lane salts read once;
    the emit matrices and the counts written once.  Operations: the commit
    reads the longest hit only at the positions the greedy walk visits, so
    only those are counted, each over the lengths of its window: ~12 per
    length (two hash multiply-adds, key and lane folding) and one compare
    per occupied slot of the (length, lane) list it probes."""
    import torch

    from wordpiece_tpu_torch.ops.word_kernel import (
        _features, _widen, probe_keys, walk_visited, word_match,
    )

    nbytes = (
        tables.slot_off.numel() * 4
        + tables.n_slots * 12
        + tables.lane_salts_t.numel() * 4
    )
    lengths = probes = 0
    sizes = (tables.slot_off[1:] - tables.slot_off[:-1]).to(torch.int64)
    kw = {k: v for k, v in tables.statics.items() if k != "unk_id"}
    for cp in cps:
        u, w = cp.shape
        nbytes += cp.numel() * cp.element_size() + u * w * 4 + u * 4
        wide = _widen(cp, w, tables.max_len)
        pos, space, _, wp, window = _features(wide, w, tables.max_len)
        _, best_len = word_match(cp, tables.k1, tables.k2, tables.tid, width=w, **kw)
        visited = walk_visited(pos, space, wp, window, best_len)
        for l, _, _, lane, in_window in probe_keys(wide, wp, window, width=w, **kw):
            probed = visited & in_window
            lengths += int(probed.sum())
            probes += int(torch.where(probed, sizes[l * 128 + lane], 0).sum())
    return int(nbytes), 12 * lengths + probes


def compact_bytes_ops(emits, total: int, cap: int) -> tuple[int, int]:
    """Bytes the compaction must move (the emit matrices and the counts
    read once; the total and the kept entries written once) and its
    operations: one compare per emit slot, one scan add per unit, a
    multiply-add per kept entry."""
    kept = min(total, cap)
    cells = sum(e.numel() for e in emits)
    units = sum(int(e.shape[0]) for e in emits)
    return cells * 4 + units * 4 + (1 + kept) * 4, cells + units + 2 * kept


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CORE_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke test of wordpiece_tpu_torch on one GPU")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="also write the profiled encode's Chrome trace to PATH")
    trace_path = ap.parse_args(argv).trace

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "wordpiece_tpu_torch")):
        print(f"chip_smoke: no wordpiece_tpu_torch package beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    t_start = time.perf_counter()

    import numpy as np

    import wordpiece_tpu_torch as wpt
    from wordpiece_tpu_torch.bench.corpus import make_corpus, make_vocab, make_vocab_bert
    from wordpiece_tpu_torch.core.length_tables import build_length_tables, load_length_tables
    from wordpiece_tpu_torch.core.vocab import parse_vocab
    from wordpiece_tpu_torch.engine_word import WIDTHS, _narrow, compact_cap
    from wordpiece_tpu_torch.ops import word_kernel_cuda as wk
    from wordpiece_tpu_torch.ops.word_kernel import word_match_commit
    from wordpiece_tpu_torch.runtime import loader
    from wordpiece_tpu_torch.utils.profiling import StageStats

    if "jax" in sys.modules or "wordpiece_tpu" in sys.modules:
        raise RuntimeError("the port pulled in jax or the JAX package")
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # ---- 1. the card ------------------------------------------------------
    card = card_line()
    emit_json({"phase": "card", "nvidia_smi": card, "torch": torch.__version__,
               "cuda": torch.version.cuda, "device_count": torch.cuda.device_count()})

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    wk.build(force=True)
    ptxas = [
        ln.strip()
        for ln in wk.build_log.splitlines()
        if any(k in ln for k in ("registers", "spill", "smem", "Compiling entry"))
    ]
    emit_json({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas})
    if not loader.available():
        raise RuntimeError("native host runtime did not build")

    # ---- 3. kernels vs plain -----------------------------------------------
    en = make_corpus(10_000_000, lang="en")
    vocab_en = parse_vocab(make_vocab_bert(en))
    host_tables = build_length_tables(vocab_en)
    tables = load_length_tables(host_tables, dev)
    words = en[:400_000].decode("utf-8", errors="ignore").split()
    rng = np.random.default_rng(2024)
    mc = wk.word_match_commit_multi
    max_err = {"match": 0, "compact": 0}

    def plain_emit(cp, tabs):
        return word_match_commit(
            cp, tabs.k1, tabs.k2, tabs.tid, width=int(cp.shape[1]), **tabs.statics
        )

    def err_of(got, want) -> int:
        if got.shape != want.shape:
            raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
        return int((got.long() - want.long()).abs().max()) if got.numel() else 0

    def check_dispatch(cps, wants, tabs, global_keys: bool, label: str):
        """One dispatch of `cps` against the plain emits `wants`: the emit
        matrices, and the compact vector against the plain compaction with
        a cap above and one below the total.  Returns the total."""
        before = (mc.launches, mc.launches_global, wk.compact_from_counts.launches)
        emits = mc(cps, tabs, global_keys=global_keys)
        after = (mc.launches, mc.launches_global, wk.compact_from_counts.launches)
        if after != (before[0] + 1, before[1] + int(global_keys), before[2]):
            raise AssertionError(f"{label}: not one launch in the "
                                 f"{'global' if global_keys else 'shared'}-key layout")
        torch.cuda.synchronize()
        for e, w in zip(emits, wants):
            err = err_of(e, w)
            max_err["match"] = max(max_err["match"], err)
            if err or not torch.equal(e, w):
                raise AssertionError(f"{label}: match kernel != plain")
        n = sum(int(c.shape[0]) for c in cps)
        total = sum(int((w != -2).sum()) for w in wants)
        shapes = [tuple(c.shape) for c in cps]
        for cap in (total + 7, total // 2):
            fused, kept = wk.word_match_commit_compact(cps, tabs, cap=cap, global_keys=global_keys)
            want = wk.compact_emits(wants, cap)
            defined = 1 + n + min(total, cap)
            err = err_of(fused[:defined], want[:defined])
            max_err["compact"] = max(max_err["compact"], err)
            if err or int(fused[0]) != total:
                raise AssertionError(f"{label}: compaction kernel != plain at cap {cap}")
            decoded = wk.decode_compact(fused.cpu().numpy(), shapes, cap)
            if cap >= total:
                if not all(np.array_equal(d, w.cpu().numpy()) for d, w in zip(decoded, wants)):
                    raise AssertionError(f"{label}: decoded compact != plain emits")
            elif decoded is not None or not all(torch.equal(e, w) for e, w in zip(kept, wants)):
                raise AssertionError(f"{label}: overflow not reported or kept emits wrong")
        return total

    for width in WIDTHS:
        mats = unit_matrices(width, words, rng)
        cps, wants = [], []
        for name, mat in mats.items():
            cp = torch.from_numpy(_narrow(mat)).to(dev)
            want = plain_emit(cp, tables)
            for global_keys in (False, True):
                keys = "global" if global_keys else "shared"
                check_dispatch([cp], [want], tables, global_keys, f"width {width}, {name}, {keys}")
                emit_json({"phase": "kernel_vs_plain", "width": width, "matrix": name,
                           "dtype": str(cp.dtype), "keys": keys, "units": mat.shape[0],
                           "emitted": int((want != -2).sum()), "max_abs_err": 0})
            cps.append(cp)
            wants.append(want)
        total = check_dispatch(cps, wants, tables, False, f"width {width}, five buckets")
        emit_json({"phase": "compact_vs_plain", "width": width, "buckets": len(cps),
                   "total": total, "caps": [total + 7, total // 2], "max_abs_err": 0})

    # One dispatch of every width, in mixed dtypes, with an empty bucket.
    mixed_np = [unit_matrices(7, words, rng)["astral"],
                unit_matrices(15, words, rng)["multilingual"].astype(np.uint16),
                unit_matrices(31, words, rng)["ascii"].astype(np.uint8),
                np.zeros((0, 15), np.uint8),
                unit_matrices(127, words, rng)["unk_heavy"]]
    mixed = [torch.from_numpy(np.ascontiguousarray(m)).to(dev) for m in mixed_np]
    dtypes = [str(m.dtype) for m in mixed]
    if len(set(dtypes[:3])) != 3:
        raise AssertionError(f"mixed dispatch without three dtypes: {dtypes}")
    mixed_wants = [plain_emit(cp, tables) for cp in mixed]
    for global_keys in (False, True):
        keys = "global" if global_keys else "shared"
        total = check_dispatch(mixed, mixed_wants, tables, global_keys, f"mixed dispatch, {keys}")
        emit_json({"phase": "mixed_dispatch_vs_plain", "keys": keys,
                   "buckets": [list(m.shape) for m in mixed], "dtypes": dtypes,
                   "total": total, "max_abs_err": 0})

    # ---- 4. main path -----------------------------------------------------
    mc.launches = mc.launches_global = wk.compact_from_counts.launches = 0
    captured: dict = {}
    dispatches = 0
    main_stats = {}
    encoders = {}

    def recording(enc, lang):
        orig = enc._dispatch_buckets

        def record(mats):
            nonlocal dispatches
            if any(m.shape[0] for m in mats):
                dispatches += 1
                if lang is not None and lang not in captured:
                    captured[lang] = [m.copy() for m in mats if m.shape[0]]
            return orig(mats)

        enc._dispatch_buckets = record
        return enc

    for lang in ("en", "ru", "ja", "zh"):
        data = en if lang == "en" else make_corpus(10_000_000, lang=lang)
        vocab = vocab_en if lang == "en" else parse_vocab(make_vocab_bert(data))
        want = loader.VocabHandle(vocab).encode(loader.decode_utf8(data))
        before = (mc.launches, wk.compact_from_counts.launches, dispatches)
        # The user entry point; each corpus's first dispatch is kept for
        # phase 5's kernel timing at the main path's shapes.
        enc = recording(wpt.make_encoder(vocab, "fast", device="cuda"), lang)
        got = enc.encode_bytes(data)
        del enc._dispatch_buckets
        main_stats[lang] = {"match": mc.launches - before[0],
                            "compact": wk.compact_from_counts.launches - before[1],
                            "dispatches": dispatches - before[2]}
        encoders[lang] = enc
        if lang == "en":
            enc_en, want_en = enc, want
            api_before = (mc.launches, wk.compact_from_counts.launches)
            api_ids = wpt.fast.encode_text(data[:200_000], vocab, device="cuda")
            api_launches = mc.launches - api_before[0]
            api_want = loader.VocabHandle(vocab).encode(loader.decode_utf8(data[:200_000]))
            if api_ids != api_want.tolist():
                raise AssertionError("fast.encode_text != native oracle")
            if api_launches < 1 or wk.compact_from_counts.launches - api_before[1] != api_launches:
                raise AssertionError("fast.encode_text did not run both kernels once per dispatch")
        ok = got.shape == want.shape and np.array_equal(got, want)
        emit_json({"phase": "main_path", "corpus": f"{lang}_10MB", "vocab": "bert_28996",
                   "ids": int(got.shape[0]), "equal_native_oracle": bool(ok),
                   "launches": main_stats[lang], "device_fallbacks": enc.device_fallbacks,
                   "verify_repairs": enc.verify_repairs, "full_fetches": enc.full_fetches})
        if not ok:
            raise AssertionError(f"{lang}: ids differ from the native oracle")
        if enc.device_fallbacks != 0 or enc.verify_repairs != 0:
            raise AssertionError(f"{lang}: device_fallbacks={enc.device_fallbacks}, "
                                 f"verify_repairs={enc.verify_repairs}")

    # A char-level vocabulary: every unit emits one id per codepoint, so
    # the first dispatch's total passes the compact cap and the engine
    # fetches the full emit matrices from the card.
    head = en[:3_000_000]
    chars = sorted(set("".join(head.decode("utf-8", errors="ignore").split())))
    char_vocab = parse_vocab(["[UNK]"] + chars + ["##" + c for c in chars])
    enc = recording(wpt.make_encoder(char_vocab, "fast", device="cuda"), None)
    got = enc.encode_bytes(head)
    want = loader.VocabHandle(char_vocab).encode(loader.decode_utf8(head))
    ok = np.array_equal(got, want)
    emit_json({"phase": "main_path", "corpus": "en_3MB", "vocab": f"char_{char_vocab.size}",
               "ids": int(got.shape[0]), "equal_native_oracle": bool(ok),
               "device_fallbacks": enc.device_fallbacks, "verify_repairs": enc.verify_repairs,
               "full_fetches": enc.full_fetches})
    if not ok:
        raise AssertionError("char vocab: ids differ from the native oracle")
    if enc.full_fetches < 1:
        raise AssertionError("char vocab: the compact cap never overflowed")
    if enc.device_fallbacks != 0 or enc.verify_repairs != 0:
        raise AssertionError(f"char vocab: device_fallbacks={enc.device_fallbacks}, "
                             f"verify_repairs={enc.verify_repairs}")

    golden_files = sorted(glob.glob(os.path.join(ROOT, "tests", "golden", "golden_*.npz")))
    if not golden_files:
        raise AssertionError("no tests/golden/*.npz")
    for path in golden_files:
        z = np.load(path)
        corpus = make_corpus(int(z["corpus_bytes"]), lang=str(z["lang"]))
        lines = make_vocab(corpus, vocab_size=int(z["vocab_size"]))
        if hashlib.sha256(corpus).hexdigest() != str(z["corpus_sha"]):
            raise AssertionError(f"{path}: regenerated corpus differs")
        if hashlib.sha256("\n".join(lines).encode()).hexdigest() != str(z["vocab_sha"]):
            raise AssertionError(f"{path}: regenerated vocab differs")
        enc = recording(wpt.make_encoder(parse_vocab(lines), "fast", device="cuda"), None)
        got = enc.encode_bytes(corpus)
        ok = got.dtype == np.int32 and np.array_equal(got, z["ids"].astype(np.int32))
        emit_json({"phase": "golden", "file": os.path.basename(path), "ids": int(got.shape[0]),
                   "byte_identical": bool(ok), "device_fallbacks": enc.device_fallbacks,
                   "verify_repairs": enc.verify_repairs})
        if not ok or got.tobytes() != z["ids"].astype(np.int32).tobytes():
            raise AssertionError(f"{path}: ids differ from the reference stream")
        if enc.device_fallbacks != 0 or enc.verify_repairs != 0:
            raise AssertionError(f"{path}: device_fallbacks={enc.device_fallbacks}, "
                                 f"verify_repairs={enc.verify_repairs}")
    launches = {"match": mc.launches, "compact": wk.compact_from_counts.launches}
    emit_json({"phase": "main_path_launches", "word_match_commit": launches["match"],
               "word_match_commit_global_keys": mc.launches_global,
               "compact": launches["compact"], "dispatches": dispatches + api_launches,
               "per_10MB": main_stats})
    if min(launches.values()) <= 0:
        raise AssertionError("the main path never launched a CUDA kernel")
    if set(launches.values()) != {dispatches + api_launches}:
        raise AssertionError(f"not one launch of each kernel per dispatch: {launches}, "
                             f"{dispatches + api_launches} dispatches")
    if mc.launches_global:
        raise AssertionError("the bert-scale main path read its keys from global memory")

    # ---- 5. numbers -------------------------------------------------------
    timing = {}
    for lang in ("en", "ru", "ja", "zh"):
        tabs = encoders[lang].dtables
        cps = [torch.from_numpy(_narrow(m)).to(dev) for m in captured[lang]]
        shapes = [tuple(c.shape) for c in cps]
        n = sum(u for u, _ in shapes)
        cap = compact_cap(n)
        # Held against the plain versions at exactly these shapes first.
        wants = [plain_emit(cp, tabs) for cp in cps]
        for global_keys in (False, True):
            total = check_dispatch(cps, wants, tabs, global_keys,
                                   f"{lang} first dispatch, {'global' if global_keys else 'shared'}")
        fused = torch.empty(1 + n + cap, dtype=torch.int32, device=dev)
        counts = fused[1 : 1 + n]
        emits = mc(cps, tabs, counts=counts)
        wk.compact_from_counts(emits, fused, cap)
        torch.cuda.synchronize()
        k_ms = device_ms(lambda: mc(cps, tabs, counts=counts), 200)
        kg_ms = device_ms(lambda: mc(cps, tabs, counts=counts, global_keys=True), 200)
        c_ms = device_ms(lambda: wk.compact_from_counts(emits, fused, cap), 200)
        scan_ms = device_ms(lambda: torch.cumsum(counts, 0, dtype=torch.int32), 200)
        kp_ms = cuda_ms(lambda: [plain_emit(cp, tabs) for cp in cps], 5)
        cp_ms = cuda_ms(lambda: wk.compact_emits(emits, cap), 50)
        # torch.masked_select sizes its output on the host, so each call
        # waits for the card: its time includes that round trip.
        vals = torch.cat([((e + 2) * 128 + torch.arange(e.shape[1], device=dev,
                                                        dtype=torch.int32)).reshape(-1)
                          for e in emits])
        mask = torch.cat([(e != -2).reshape(-1) for e in emits])
        if not torch.equal(torch.masked_select(vals, mask)[:cap], fused[1 + n : 1 + n + min(total, cap)]):
            raise AssertionError(f"{lang}: masked_select != the compaction kernel")
        lib_ms = cuda_ms(lambda: torch.masked_select(vals, mask), 50)
        kb, ko = kernel_bytes_ops(cps, tabs)
        cb, co = compact_bytes_ops(emits, total, cap)
        k_bound, k_by = bound_ms(kb, ko)
        c_bound, c_by = bound_ms(cb, co)
        timing[lang] = {
            "match": {"ms": k_ms, "ms_global_keys": kg_ms, "plain_ms": kp_ms, "bytes": kb,
                      "ops": ko, "bound_ms": k_bound, "bound_by": k_by},
            "compact": {"ms": c_ms, "cumsum_ms": scan_ms, "plain_ms": cp_ms,
                        "library_ms": lib_ms, "bytes": cb, "ops": co, "bound_ms": c_bound,
                        "bound_by": c_by},
        }
        if not all(v > 0 for v in (k_ms, kg_ms, c_ms, kp_ms, cp_ms, lib_ms, kb, ko, cb, co)):
            raise AssertionError(f"{lang}: a time or a bound term was not measured")
        emit_json({"phase": "kernel_time", "corpus": f"{lang}_10MB",
                   "shapes": "first dispatch, every non-empty bucket", "card": card,
                   "buckets": [{"width": w, "units": u, "dtype": str(c.dtype)}
                               for (u, w), c in zip(shapes, cps)],
                   "total": total, "cap": cap, **timing[lang]})

    runs = []
    for _ in range(5):
        enc_en.stats = StageStats()
        t0 = time.perf_counter()
        got = enc_en.encode_bytes(en)
        dt = time.perf_counter() - t0
        runs.append((dt, enc_en.stats.report()))
    if not np.array_equal(got, want_en):
        raise AssertionError("timed en encode: ids differ from the native oracle")
    best = min(runs, key=lambda r: r[0])
    median_s = float(np.median([r[0] for r in runs]))
    emit_json({"phase": "e2e", "corpus": "en_10MB", "vocab": "bert_28996", "card": card,
               "seconds": [r[0] for r in runs], "best_s": best[0], "median_s": median_s,
               "mb_per_s": len(en) / best[0] / 1e6, "median_mb_per_s": len(en) / median_s / 1e6,
               "stages": best[1], "device_fallbacks": enc_en.device_fallbacks})

    # Where the device time of one 10 MB en encode goes, and how much of
    # the encode's wall time the card is busy at all.
    enc_en.stats = None
    wall, rows, busy_us = device_profile(lambda: enc_en.encode_bytes(en), trace_path)
    emit_json({"phase": "profile", "corpus": "en_10MB", "card": card, "wall_ms": wall * 1e3,
               "device_busy_ms": None if busy_us is None else busy_us / 1e3,
               "device_busy_share": None if busy_us is None else busy_us / 1e3 / (wall * 1e3),
               "device_rows": rows, "trace": trace_path})

    emit_json({"phase": "done", "seconds": time.perf_counter() - t_start})
    t_en = timing["en"]
    emit_json({"kernels": [
        {
            "name": "word_match_commit",
            "route": "cuda",
            "source": "wordpiece_tpu_torch/csrc/word_kernel.cu",
            "replaces": "wordpiece_tpu/ops/word_kernel_pallas.py:68",
            "launches": launches["match"],
            "max_abs_err": max_err["match"],
            "ms": t_en["match"]["ms"],
            "plain_ms": t_en["match"]["plain_ms"],
            "bound_ms": t_en["match"]["bound_ms"],
            "bound_by": t_en["match"]["bound_by"],
            "library_ms": None,
        },
        {
            "name": "compact_from_counts",
            "route": "cuda",
            "source": "wordpiece_tpu_torch/csrc/word_kernel.cu",
            "replaces": "wordpiece_tpu/ops/word_kernel_pallas.py:349",
            "launches": launches["compact"],
            "max_abs_err": max_err["compact"],
            "ms": t_en["compact"]["ms"],
            "plain_ms": t_en["compact"]["plain_ms"],
            "bound_ms": t_en["compact"]["bound_ms"],
            "bound_by": t_en["compact"]["bound_by"],
            "library_ms": t_en["compact"]["library_ms"],
        },
    ]})
    print(card, flush=True)
    emit_json({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                      "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

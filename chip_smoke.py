#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (wordpiece_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (sm_90a),
nvcc and a C++ toolchain.  Imports torch and the port, never jax or the
JAX package.  Phases, each fatal on failure:

 1. the card: name and power limit from nvidia-smi;
 2. build: nvcc compiles csrc/word_kernel.cu; ptxas' registers, shared
    memory and spills are printed;
 3. kernel vs plain: the CUDA kernel and its plain PyTorch version, on
    the card, on the same unit matrices (random ASCII, multilingual,
    astral-plane, UNK-heavy, empty rows; a row count that ends in a
    partial block) at widths 7/15/31/127 with the bert-shaped vocab; emit
    matrices and decoded compact vectors must be equal (integers:
    tolerance exactly 0), and a cap below the total must be detected with
    the counts and the kept emit matrices intact;
 4. main path: the kernel's launch count is set to 0, then the fast engine
    encodes 10 MB en/ru/ja/zh corpora on the bert-shaped vocab through the
    user entry points (ids must equal the native oracle), 3 MB of en on a
    char-level vocab (past the compact cap: the full-emit fetch) and every
    tests/golden/*.npz stream (byte-identical); the count must be > 0,
    and device_fallbacks and verify_repairs 0;
 5. numbers: at the en first chunk's bucket shapes, the kernel and its
    plain version are held equal (emit matrices and the decoded compact
    vector) and timed by CUDA events; the kernel's bound, the 10 MB en
    encode rate (min and median of 5) with its stage breakdown, and one more such
    encode under torch.profiler: device time per kernel and the card's
    busy share of the wall time (--trace PATH also writes its trace).

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


def kernel_bytes_ops(cp, tables) -> tuple[int, int]:
    """Bytes one launch must move (each input read once, the output written
    once) and the integer operations it does on these inputs: per probed
    length ~12 (two hash multiply-adds, key and lane folding), per probed
    candidate row 3 compares.  Counts what this data needs: each position
    probes only the lengths of its window."""
    import torch

    from wordpiece_tpu_torch.ops.word_kernel import _features, _widen

    u, w = cp.shape
    nbytes = (
        cp.numel() * cp.element_size()
        + u * w * 4
        + tables.packed.numel() * 4
        + tables.rows_off_t.numel() * 4
        + tables.lane_salts_t.numel() * 4
    )
    wide = _widen(cp, w, tables.max_len)
    _, _, _, _, window = _features(wide, w, tables.max_len)
    lmax = torch.clamp(window, max=tables.max_len)
    b_l = [0] + [
        tables.rows_off[l + 1] - tables.rows_off[l] for l in range(1, tables.max_len + 1)
    ]
    cum = torch.tensor(
        [sum(b_l[: k + 1]) for k in range(len(b_l))], dtype=torch.int64, device=cp.device
    )
    probes = int(cum[lmax].sum())
    lengths = int(lmax.sum())
    return int(nbytes), 3 * probes + 12 * lengths


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

    # ---- 3. kernel vs plain ----------------------------------------------
    en = make_corpus(10_000_000, lang="en")
    vocab_en = parse_vocab(make_vocab_bert(en))
    host_tables = build_length_tables(vocab_en)
    tables = load_length_tables(host_tables, dev)
    words = en[:400_000].decode("utf-8", errors="ignore").split()
    rng = np.random.default_rng(2024)
    max_err = 0
    for width in WIDTHS:
        mats = unit_matrices(width, words, rng)
        cps, plains = [], []
        for name, mat in mats.items():
            cp = torch.from_numpy(_narrow(mat)).to(dev)
            got = wk.word_match_commit_bucket(cp, tables)
            want = word_match_commit(
                cp, tables.k1, tables.k2, tables.tid, width=width, **tables.statics
            )
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            n_emit = int((want != -2).sum())
            emit_json({"phase": "kernel_vs_plain", "width": width, "matrix": name,
                       "dtype": str(cp.dtype), "units": mat.shape[0], "emitted": n_emit,
                       "mismatches": int((got != want).sum()), "max_abs_err": err})
            if err != 0 or not torch.equal(got, want):
                raise AssertionError(f"kernel != plain at width {width}, matrix {name}")
            max_err = max(max_err, err)
            cps.append(cp)
            plains.append(want.cpu().numpy())
        shapes = [tuple(c.shape) for c in cps]
        cap = sum(u * w for u, w in shapes)
        fused, _ = wk.word_match_commit_compact(cps, tables, cap=cap)
        fused = fused.cpu().numpy()
        decoded = wk.decode_compact(fused, shapes, cap)
        for d, p in zip(decoded, plains):
            if not np.array_equal(d, p):
                raise AssertionError(f"decoded compact != plain emits at width {width}")
        # A cap below the total: the decode must report the overflow, the
        # counts must stay whole, and the emit matrices the compact call
        # keeps on the card (what the engine's full-emit fetch copies) must
        # equal the plain ones.
        total = int(fused[0])
        short, kept = wk.word_match_commit_compact(cps, tables, cap=total // 2)
        short = short.cpu().numpy()
        n_rows = sum(u for u, _ in shapes)
        if (int(short[0]) != total
                or wk.decode_compact(short, shapes, total // 2) is not None
                or not np.array_equal(short[1 : 1 + n_rows], fused[1 : 1 + n_rows])):
            raise AssertionError(f"compact overflow not reported at width {width}")
        for e, p in zip(kept, plains):
            if not np.array_equal(e.cpu().numpy(), p):
                raise AssertionError(f"kept emits != plain emits at width {width}")
        emit_json({"phase": "compact_vs_plain", "width": width, "total": total,
                   "equal": True, "overflow_cap": total // 2, "overflow_detected": True})

    # ---- 4. main path -----------------------------------------------------
    wk.word_match_commit_bucket.launches = 0
    captured: list = []
    main_stats = {}
    for lang in ("en", "ru", "ja", "zh"):
        data = en if lang == "en" else make_corpus(10_000_000, lang=lang)
        vocab = vocab_en if lang == "en" else parse_vocab(make_vocab_bert(data))
        want = loader.VocabHandle(vocab).encode(loader.decode_utf8(data))
        before = wk.word_match_commit_bucket.launches
        if lang == "en":
            # The user entry point; the dispatches' unit matrices are kept
            # for phase 5's kernel timing at the main path's shapes.
            enc = wpt.make_encoder(vocab, "fast", device="cuda")
            orig = enc._dispatch_buckets

            def recording(mats, orig=orig):
                captured.append([m.copy() for m in mats])
                return orig(mats)

            enc._dispatch_buckets = recording
            got = enc.encode_bytes(data)
            main_stats[lang] = wk.word_match_commit_bucket.launches - before
            del enc._dispatch_buckets
            enc_en, want_en = enc, want
            api_ids = wpt.fast.encode_text(data[:200_000], vocab, device="cuda")
            api_want = loader.VocabHandle(vocab).encode(loader.decode_utf8(data[:200_000]))
            if api_ids != api_want.tolist():
                raise AssertionError("fast.encode_text != native oracle")
        else:
            enc = wpt.make_encoder(vocab, "fast", device="cuda")
            got = enc.encode_bytes(data)
            main_stats[lang] = wk.word_match_commit_bucket.launches - before
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
    enc = wpt.make_encoder(char_vocab, "fast", device="cuda")
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
        enc = wpt.make_encoder(parse_vocab(lines), "fast", device="cuda")
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
    launches = wk.word_match_commit_bucket.launches
    emit_json({"phase": "main_path_launches", "word_match_commit": launches,
               "per_10MB": main_stats})
    if launches <= 0:
        raise AssertionError("the main path never launched the CUDA kernel")

    # ---- 5. numbers -------------------------------------------------------
    first = [m for m in captured[0] if m.shape[0]]
    bucket_rows = []
    k_ms = p_ms = 0.0
    n_bytes = n_ops = 0
    first_cps, first_plains = [], []
    for m in first:
        cp = torch.from_numpy(_narrow(m)).to(dev)
        width = m.shape[1]
        # Held against the plain version at exactly these shapes first.
        got = wk.word_match_commit_bucket(cp, tables)
        want = word_match_commit(
            cp, tables.k1, tables.k2, tables.tid, width=width, **tables.statics
        )
        err = int((got.long() - want.long()).abs().max())
        if err != 0 or not torch.equal(got, want):
            raise AssertionError(f"kernel != plain at the main path's width-{width} bucket")
        max_err = max(max_err, err)
        first_cps.append(cp)
        first_plains.append(want.cpu().numpy())
        km = cuda_ms(lambda: wk.word_match_commit_bucket(cp, tables), 200)
        pm = cuda_ms(
            lambda: word_match_commit(
                cp, tables.k1, tables.k2, tables.tid, width=width, **tables.statics
            ),
            5,
        )
        b, o = kernel_bytes_ops(cp, tables)
        bucket_rows.append({"width": width, "units": m.shape[0], "dtype": str(cp.dtype),
                            "ms": km, "plain_ms": pm, "bytes": b, "ops": o,
                            "max_abs_err": err})
        k_ms += km
        p_ms += pm
        n_bytes += b
        n_ops += o
    shapes = [tuple(c.shape) for c in first_cps]
    cap = compact_cap(sum(u for u, _ in shapes))
    fused, _ = wk.word_match_commit_compact(first_cps, tables, cap=cap)
    decoded = wk.decode_compact(fused.cpu().numpy(), shapes, cap)
    if decoded is None or not all(np.array_equal(d, p) for d, p in zip(decoded, first_plains)):
        raise AssertionError("decoded compact != plain emits at the main path's shapes")
    if not (k_ms > 0 and p_ms > 0 and n_bytes > 0 and n_ops > 0):
        raise AssertionError("kernel_time: a time or a bound term was not measured")
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / CORE_OPS_PER_S * 1e3
    emit_json({"phase": "kernel_time", "shapes": "en 10MB first chunk, every non-empty bucket",
               "card": card, "buckets": bucket_rows, "ms": k_ms, "plain_ms": p_ms,
               "bound_bytes_ms": t_bytes, "bound_ops_ms": t_ops,
               "dispatches_per_10MB_en": len(captured)})

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
    emit_json({"kernels": [{
        "name": "word_match_commit",
        "route": "cuda",
        "source": "wordpiece_tpu_torch/csrc/word_kernel.cu",
        "replaces": "wordpiece_tpu/ops/word_kernel_pallas.py:68",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }]})
    print(card, flush=True)
    emit_json({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                      "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

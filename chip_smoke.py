#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (wordpiece_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (sm_90a),
nvcc and a C++ toolchain.  Imports torch and the port, never jax or the
JAX package.  Phases, each fatal on failure:

 1. the card: name and power limit from nvidia-smi;
 2. build: nvcc compiles csrc/word_kernel.cu (the match+commit kernel, the
    compaction kernel and the split match and commit kernels, one library),
    csrc/match_fast.cu (the fast-stream engine's probe),
    csrc/text_features.cu (the features kernel), csrc/commit.cu (the
    commit kernels), csrc/linear_match.cu (the linear engine's match
    over the suffix array) and csrc/utf8_decode.cu (the fast-stream
    engine's decode), all six at once; ptxas' registers, shared memory and
    spills are printed for each;
 3. kernels vs plain: on the card, on the same unit matrices (random ASCII,
    multilingual, astral-plane, UNK-heavy, empty rows; a row count that
    ends in a partial tile) at widths 7/15/31/127 with the bert-shaped
    vocab, the match+commit kernel equals its plain PyTorch version, once
    with the keys staged in shared memory and once with the global-key
    layout forced; the five matrices of a width go through one dispatch
    whose compact vector (compaction kernel) must equal the plain
    compaction (compact_emits), with a cap above, at and below the total
    (the overflow keeps the true total, whole counts and the emit
    matrices); then one dispatch of all four widths in mixed dtypes and an
    empty bucket, in both key layouts.  Then the compaction alone on
    synthetic emits: the en first dispatch's shapes and 200,000 units
    (many blocks) with the cap above, at and below the total, and two
    calls back to back on two streams.  Integers: tolerance exactly 0;
 4. main path: every kernel's launch count is set to 0, then the fast
    engine encodes 10 MB en/ru/ja/zh corpora on the bert-shaped vocab
    through the user entry points (ids must equal the native oracle), 3 MB
    of en on a char-level vocab (past the compact cap: the full-emit
    fetch) and every tests/golden/*.npz stream (byte-identical); both
    kernels must have launched once per dispatch (the features and commit
    kernels not at all), and device_fallbacks and verify_repairs must be 0;
 5. numbers: at the first dispatch's bucket shapes of each of en/ru/ja/zh,
    both kernels are held equal to their plain versions again, then timed
    by CUDA events (the kernels behind a spin kernel, so that the events
    time the card and not the host's enqueue), beside their plain
    versions, torch.masked_select (the one PyTorch call that computes the
    compaction) and each kernel's bound; the profile of one en dispatch
    must show the two word kernels and nothing else (no scan launch
    between them); the 10 MB en encode once more, its ids held to the
    oracle, and one more such encode under torch.profiler: device time per kernel and the card's busy share of
    the wall time (--trace PATH also writes its trace);
 6. linear main path: the word kernels' counts are set to 0, then the
    linear engine encodes the same 10 MB en/ru/ja/zh corpora through
    linear.encode_text(..., device="cuda") and every golden stream; ids
    must equal the oracle and the goldens, each encoder must have run its
    batch program on the card (device_batches > 0; nk is printed), and
    every pipelined dispatch runs under torch's sync debug mode, so a host
    synchronisation in it fails the run.  Then the char-level vocab
    (compact-cap overflow: full_fetches > 0), the prefix-doubling fallback
    (a 5,000-symbol vocab with 49-90-codepoint tokens: nk > 24) and the
    MAX_SLOT_LEN scalar route (a 100-codepoint token: no device batch),
    each against the oracle; the features, match and commit wrappers must
    have been called once per device batch run by launches (device_batches
    less graph_replays: a replay calls no wrapper), the word kernels and
    the probe not at all;
 7. linear numbers: the 10 MB en encode once more, its ids held to the
    oracle; one encode under torch.profiler (device time by op
    class, launches per batch, busy share), which must show the match
    kernels and no torch scan (cummax); and, at the en first batch's
    shapes, held to the oracle first, the device time of the whole batch
    and of each part (sort, LCP and who-tables, features, match, commit:
    the last three the hand kernels; the match's plain version beside) by
    CUDA events around CUDA graph replays (the capture also proves the
    batch program has no host sync), the fallback's suffix array and LCP
    over that batch's S, and each part's bytes bound; at that batch's
    shapes the features and commit kernels are first held to their plain
    versions (exact, whole outputs) and the batch's CUDA graph nodes are
    counted.  Then the match kernels (match_from_sa) against
    match_from_sa_plain, whole outputs, exactly, on the en first batch,
    the doubling fallback's first batch, every bench/linear_cases.py case
    and a max_len 96 case of 2^20 ranks; the kernels and memsets of one
    call, read from a CUDA graph of it (KERNEL_LAUNCHES kernels, MEMSETS
    memsets); the kernels' time by CUDA events behind a spin kernel at the
    en first batch and at the 2^20 ranks, each beside its bound, its plain
    version's time and its kernels' device time from a profile; with
    --compare DIR, the kernels of the checkout at DIR timed beside these in
    turns on those two inputs;
7b. linear graphs: on a card LinearEncoder replays one CUDA graph a shape
    key (bucket, cap, input dtypes) for each batch.  A fresh encoder
    encodes 10 MB en with StageStats attached (ids equal to the oracle,
    batches_graph > 0, batches_graph + batches_eager = device_batches, one
    capture a key, each kernel wrapper's .launches, set to 0 before, equal
    to batches_eager: a capture counts none); then each of its batches again, all replays, each
    equal, ids and positions, to _linear_batch_compact by launches at its
    true length and to the oracle; a text above U+FFFF through
    encode_codepoints three times (an int32 codepoint key, replays equal
    to the oracle); the char-level vocab on 1 MB with the cap ratio forced
    below its density once the small caps' graphs exist (replays
    overflow, re-run by launches: full_fetches, equal to the oracle); a
    fresh encoder's two 2 MB encodes under torch.profiler, the first
    capturing inside the profile, the second replaying, both equal to the
    oracle, each batch running the features, match and commit kernels once
    each in the profile, read by kernel name, and the wrappers counting
    the batches run by launches alone; and the host's enqueue of the
    en first batch (the median of 25, the card idle before each), by a
    graph's replay and by stream launches, in turns;
 8. stream kernel vs plain: on the card, the probe kernel
    (match_positions) equals its plain version, whole [n] outputs with the
    padding, in the tag layout the kernel chooses and with global tags forced,
    on the first 1 MB of each of en/ru/ja/zh (their bert-shaped vocabs,
    whose tables probe chains of two and more slots), on each piece of the
    10 MB en document as the main path cuts it (doc_pieces: buckets of 2^22
    and 2^21 positions), on UNK-heavy, astral-plane, punctuation-dense text, a
    2,000-codepoint space-free run and n = 1, on a 150,000-token vocab
    whose 2^20 tags do not fit in shared memory, and on the 5,000-symbol
    vocab of 49-90-codepoint tokens (max_len past the kernel's 32-bit
    mask: the ascending pass);
8b. features and commit kernels vs plain: on the card, the features
    kernel (compute_features) equals compute_features_plain, every field
    whole with the padding, and the commit kernels (commit_with_positions)
    equal commit_with_positions_plain (ids, positions, count) on the
    probe kernel's matches and on random matches inside the window (the
    plain commit loops to the fixed point, as the kernels do): on the
    first 1 MB of each of
    en/ru/ja/zh and each piece of the 10 MB en document (padded as the
    engine pads them),
    and on bench/stream_cases.py's cases (n = 1, 128, around one and two
    tiles of either kernel (2,048 positions for the commit, 4,096 for the
    features), n_valid < n, spacing-free and all-space texts over 4 and
    150 tiles, the 2,000-codepoint space-free run, the dry run's 5,000-`q`
    run, punctuation-dense, CJK and astral-plane text), and the commit
    kernels also on its commit_cases (units at tile edges, words over 2
    and 3 tiles with their only failure in the last, a failure in a tile
    with no unit start, all-space tiles between units, n_valid after a
    straddling unit) with their own matches.  Integers: tolerance
    exactly 0;
 9. stream main path: every kernel's launch count is set to 0, then
    make_encoder(vocab, "fast-stream", device="cuda") encodes the 10 MB
    en/ru/ja/zh corpora (ids equal to the native oracle) and every golden
    stream (byte-identical), and the CLI's fast-stream mode runs on one
    file; the features, probe and commit kernels and the decode's count
    and write kernels must each have launched once a piece (the encoders'
    StageStats count the pieces; the 10 MB en and ru texts pass the
    ladder's cap, so they run in pieces, the first written from the
    document's count and each later one counted on its own), the probe
    with its tags in shared memory (read from its count of global-tag
    launches), and the word kernels not at all.
    Then, in this process, a one-rank nccl group: ShardedFastEncoder on a
    1-D grid and encode_2d_parallel on a 1 x 1 grid encode 10 MB en, equal
    to the oracle, with one launch of each of the three kernels each;
10. stream numbers: the probe kernel's time by CUDA events behind a spin
    kernel at the en first 1 MB and at each piece of the 10 MB en document
    (shared tags, and global tags forced), its plain version's time at
    each, its bound, and their sums over the pieces (a 10 MB call, the
    kernels line's numbers); the features and commit kernels' times the
    same way at the same shapes (the commit on the probe's matches), beside their plain
    versions' and their bounds, and one call of each captured in a CUDA
    graph, whose nodes must be one kernel and one memset for the features,
    and three kernels and one memset for the commit; the 10 MB en
    fast-stream rate (min and median of 5) with each part's time of the
    pieced encode_bytes (stream_parts: the bytes into the pinned slot,
    H2D, the decode's count with its read, the cut, then a piece's write,
    features, match and commit, a later piece's H2D and count and the id
    count's read and ids' copy of the piece before it, last the ids' copy
    out) and each device part's host enqueue time; with --compare DIR, the same
    encode's rate and parts (each checkout's own stream_parts), and the
    linear rate, from the checkout at DIR and from this one, each in a
    process of its own, in the same turns as phase 7's; the peak of
    max_memory_allocated, and one encode under torch.profiler (device time
    by op class, busy share), which must show the three kernels, a decode
    kernel and no torch scan (cummin) or scatter kernel;
10b. the UTF-8 decode: the count and write kernels (count_codepoints,
    write_codepoints) against decode_plain, the count and the whole int32
    output at the count, one more and the engine's bucket (written into
    memory the allocator hands back dirty, so the zeros are the kernel's),
    on uniform and edge-byte strings at lengths around a thread's 16 bytes
    and the 4,096-byte tile, valid text with a 2-, 3- or 4-byte sequence
    across such an edge or cut off by the end there, random valid text of
    every width, every golden text and the 10 MB en/ru/ja/zh corpora; on
    each of those corpora past the ladder's cap, the count's tile prefixes
    (against the plain count's) and each piece's bucket as the main path
    writes it (the first from the document's count, each later one from
    its own, given the cut's count).  Integers: exactly 0.  Then, on the
    10 MB en document as the main path decodes it (the document's count
    and the pieces' writes and later counts), the decode's device time
    (counts with their memsets and copies, writes, both) by CUDA events
    behind a spin kernel, beside its bound (2 bytes a byte in, 1 a byte of
    a later piece's count and 4 a position of the buckets) and the plain version's time on the card,
    and one encode_bytes under torch.profiler; the whole call by
    encode_bytes against the host's decode, pad and pageable copy
    (encode_codepoints of decode_utf8), in turns, on the 10 MB en file and
    a 3,000-byte article; and the card's peak over what it held, a 10 MB
    call each way, which the decode must not raise;
11. split kernels vs plain: the word kernel split in two for the
    vocab-partitioned path.  The match kernel (word_match_packed: every
    position's longest hit, one packed int32) equals the plain word_match,
    packed, whole [U, W], in both key layouts, and the commit kernel
    (word_commit_packed) equals the plain word_commit, emits and counts;
    the pair wrappers (word_match_multi, word_commit_multi) once each: on
    phase 3's five matrices of each width 7/15/31/127 (one dispatch each,
    whole bert-shaped table), and on phase 3's mixed dispatch (three
    dtypes, an empty bucket, partial tiles) against the whole table and
    every partition of shard_word_tables(..., 2) and (..., 3) and of a
    tiny vocab whose partitions 1 and 2 of 3 hold no slot; the packed max
    over the partitions equals the JAX two-pmax combine of their pairs and
    the whole table's matches, and its commit equals the fused kernel's
    plain emits.  Then fingerprint collisions: the plain count of those
    the longest-first match meets on the en first dispatch with the bert
    vocab, and a vocab with more (a search over random strings for keys
    that share list, kind and fingerprint with queries longer than their
    true hit), on which the match kernel equals the plain version.  The
    split pipeline (match on every partition, max-combine, commit,
    compact_from_counts) equals the fused kernel and its compaction on the
    en first dispatch.  Then both kernels' times (the match in both key
    layouts) by CUDA events behind a spin kernel at the en
    first dispatch's shapes, with the fused kernel's in the same call,
    their plain versions' times and their bounds.  Integers: exactly 0;
12. word sharded main paths, on a one-rank nccl group in this process:
    the 1-D ShardedWordEncoder, the 1 x 1 2-D ShardedWordEncoder and
    MultiHostWordEncoder each encode 10 MB en, equal to the native oracle,
    each with every launch count set to 0 just before it: the 1-D and
    multi-process paths launch the fused kernel and the compaction once
    per dispatch and no split kernel; the 2-D path the match, the commit
    and the compaction once per dispatch and no fused kernel.  The
    torch.distributed collectives are counted: one per 1-D dispatch (the
    gather), two per 2-D dispatch (the packed matches' all_reduce and the
    gather);
13. dry run: wordpiece_tpu_torch.dryrun.dryrun_multichip on every card,
    one nccl rank (a process of its own) a card, each rank bound to its
    card: the stream engine on the demo text (1-D; a (n/2) x 2 grid from
    four cards), the 1-D word engine (and the (n/2) x 2 grid), the 1-D
    word engine on a 4.5 MB corpus with an 8k vocab and a 5,000-codepoint
    space-free run, and MultiHostWordEncoder on each rank's byte range of
    it.  Each rank holds every path's ids to the native oracle, and its
    kernel launches to one a dispatch (the probe one an encode), with
    every count set to 0 just before the path; verify_repairs and
    device_fallbacks must be 0 and the 1-D word path must issue one
    collective a dispatch.  Then entry()'s one-dispatch step on the card,
    exact against the plain word_match_commit.  The kernels line gives
    each kernel's launches in the dry run (rank 0's, every path summed)
    as `dryrun_launches`: the fused kernel, the compaction, the features,
    probe and commit kernels launch on one card, the split kernels only
    from four, the linear match never (the dry run has no linear path);
14. harness: every kernel's launch count is set to 0, then the
    cross-engine harness's command runs in a temporary directory,
    wordpiece_tpu_torch.bench.harness.main(["--langs", "en", "ru", "ja",
    "zh", "--corpus-size", "10", "--iters", "3", "--collect", "--device",
    "cuda"]): for each language a 10 MB corpus and its make_vocab vocab
    (not the bert-shaped one), the fast, fast-stream and linear engines on
    the card and the native host engine, each one warm-up and the min of 3
    timed encodes; its table goes to the output.  For each language the
    four collected id files must be byte-identical and the four counts
    equal; every encoder the harness made (api.make_encoder is wrapped for
    the phase) must have run on the card, the word encoders with
    verify_repairs and device_fallbacks 0, the linear encoders with
    device_batches > 0; the word kernel and the compaction must have
    launched alike, the probe once a fast-stream piece (the encoders'
    StageStats count the pieces), the linear match once a linear device
    batch run by launches (not a graph's replay), the features and commit
    kernels once for each of both, the decode's two kernels once a
    fast-stream piece, the split kernels not at all.  The kernels line gives
    each kernel's launches in this run as `harness_launches`;
15. stress: the reference's differential stress configurations
    (bench/stress_cases.py, the JAX package's reference-scale stress test's
    generators and seed 17), positive and negative, through
    make_encoder(..., device="cuda") against the native oracle, every
    launch count set to 0 just before each encode and read just after:
    spaced_10M (10,000,000 chars of Zipf words, >= 25,000 random-split
    pieces, max_len <= 16, unk_id -1) through fast, linear and
    fast-stream; single_unit_1M (one 1,000,000-codepoint unit, 30,000
    parts, tokens up to hundreds of codepoints) through fast (its overflow
    route), linear (its scalar route: max_len past MAX_SLOT_LEN) and
    fast-stream (the probe's ascending pass, the commit's walk over one
    unit hundreds of tiles long); mid_scale (100,000 and 500,000 chars,
    min(30,000, len // 10) parts) through fast and fast-stream.  Each row
    gives the ids, the seconds of the encode, the route counts (fast:
    dispatches, overflow units and units encoded on the host; linear:
    device batches, scalar-route units, the graph counters and, the linear
    encode run under torch.profiler, each hand kernel's runs by kernel
    name), the launches and, for fast,
    verify_repairs and device_fallbacks, which must be 0.  On the texts of
    one unit the features and commit kernels are also held to their plain
    versions (as in 8b) on the probe kernel's matches: the longest chain
    the commit's walk can be given.  Fast-stream must launch the
    features, probe and commit kernels once a piece (its StageStats count
    them: spaced_10M passes the ladder's cap), the word kernel and the
    compaction launch alike, fast-stream also the decode's count and
    write kernels once a piece; every linear batch must be a graph's
    replay or run by launches, run the features, match and commit kernels
    once each in the profile, and the wrappers count one call each a
    batch run by launches.  The kernels line gives each kernel's wrapper
    calls in this phase as `stress_launches`.

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
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

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


def graph_ms(fn, iters: int) -> float:
    """Mean device time of fn() in ms by CUDA events around replays of a
    CUDA graph of it: for a call of hundreds of small launches, which the
    host enqueues slower than the card runs them and which would overflow
    the launch queue behind device_ms's spin kernel.  The capture also
    fails on any host synchronisation in fn."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
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


def synthetic_emits(rng, shapes, dev):
    """Emit matrices int32[U, W] of the given shapes, from a seed: a token
    id in 30% of the cells, -2 elsewhere; and the compact vector's counts
    segment for them."""
    import numpy as np
    import torch

    emits = []
    for u, w in shapes:
        ids = rng.integers(0, 30_000, size=(u, w), dtype=np.int32)
        emits.append(torch.from_numpy(np.where(rng.random((u, w)) < 0.3, ids, -2)
                                      .astype(np.int32)).to(dev))
    counts = torch.cat([(e != -2).sum(dim=1, dtype=torch.int32) for e in emits])
    return emits, counts


def compact_cases(dev, rng) -> list:
    """The compaction kernel against compact_emits on synthetic emits: the
    en first dispatch's bucket shapes and 200,000 units in four buckets of
    mixed widths (many blocks, several chunks a block), with the cap above,
    at and below the total; then two calls back to back on two streams.
    Whole defined entries, exactly.  Returns one report row per case."""
    import torch

    from wordpiece_tpu_torch.ops import word_kernel_cuda as wk

    cc = wk.compact_from_counts

    def run(emits, counts, cap, stream=None):
        n = counts.shape[0]
        fused = torch.full((1 + n + cap,), -9, dtype=torch.int32, device=dev)
        fused[1 : 1 + n] = counts
        if stream is not None:
            stream.wait_stream(torch.cuda.current_stream())
        before = cc.launches
        with torch.cuda.stream(stream or torch.cuda.current_stream()):
            cc(emits, fused, cap)
        if cc.launches != before + 1:
            raise AssertionError("the compaction did not launch once")
        return fused, n

    def check(fused, emits, n, total, cap, label):
        torch.cuda.synchronize()
        want = wk.compact_emits(emits, cap)
        defined = 1 + n + min(total, cap)
        err = int((fused[:defined].long() - want[:defined].long()).abs().max())
        if err or int(fused[0]) != total:
            raise AssertionError(f"{label}: compaction kernel != plain at cap {cap}")
        return err

    rows = []
    cases = {"en_first_dispatch_shapes": [(11_280, 7), (2_986, 15), (2, 31)],
             "200k_units": [(120_000, 7), (60_000, 15), (15_000, 31), (5_000, 127)]}
    for name, shapes in cases.items():
        emits, counts = synthetic_emits(rng, shapes, dev)
        total = int(counts.sum())
        for cap in (total + 7, total, total // 2):
            fused, n = run(emits, counts, cap)
            err = check(fused, emits, n, total, cap, name)
            rows.append({"case": name, "buckets": [list(s) for s in shapes], "units": n,
                         "total": total, "cap": cap, "max_abs_err": err})

    # Two calls back to back on two streams, each with its own scratch.
    sets = [synthetic_emits(rng, [(40_000, 7), (9_000, 15)], dev),
            synthetic_emits(rng, [(30_000, 15), (700, 127)], dev)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    runs = [(*run(e, c, int(c.sum()), st), e, int(c.sum())) for (e, c), st in zip(sets, streams)]
    for k, (fused, n, e, t) in enumerate(runs):
        err = check(fused, e, n, t, t, f"stream {k}")
        rows.append({"case": f"two_streams_{k}", "units": n, "total": t, "cap": t,
                     "max_abs_err": err})
    return rows


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CORE_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# ---- phase 6/7 helpers -----------------------------------------------------
def doubling_vocab(rng):
    """Vocabulary lines whose packed sort keys would need nk > 24 passes (the
    linear engine's prefix-doubling fallback) — 5,000 distinct symbols (13
    bits, 2 per key) in tokens of 49-90 codepoints, plus single-symbol
    prefix and suffix tokens — and a small text of whole tokens, token
    heads and single-symbol words."""
    syms = 0x100 + rng.permutation(5000)  # none is a space, punctuation or CJK
    longs, i = [], 0
    while i < syms.shape[0]:
        size = int(rng.integers(49, 91))
        longs.append("".join(chr(c) for c in syms[i : i + size]))
        i += size
    singles = [chr(c) for c in syms[:400]]
    words = []
    for _ in range(600):
        tok, r = longs[int(rng.integers(len(longs)))], rng.random()
        if r < 0.4:
            words.append(tok)
        elif r < 0.7:
            words.append(tok[: int(rng.integers(1, 40))])
        else:
            k = rng.integers(0, len(singles), size=int(rng.integers(1, 8)))
            words.append("".join(singles[int(j)] for j in k))
    return ["[UNK]"] + longs + singles + ["##" + c for c in singles], " ".join(words)


def op_class(name: str) -> str:
    """Class of a CUDA kernel of a torch-ops program, by its name."""
    low = name.lower()
    if "match_positions" in low:
        return "match_positions kernel"
    if "text_features_kernel" in low:
        return "features kernel"
    if "commit_" in low and "_kernel" in low:
        return "commit kernels"
    if "sa_match_" in low:
        return "linear match kernels"
    if "utf8_" in low and "_kernel" in low:
        return "utf8 decode kernels"
    if low.startswith(("memcpy", "memset")):
        return "copies (memcpy)"
    if "sort" in low or "radix" in low:
        return "sorts"
    if "scan" in low:
        return "scans (cummax/cummin/cumsum)"
    if "scatter" in low:
        return "scatters"
    if "index" in low or "gather" in low:
        return "gathers"
    if "cat" in low or "copy" in low:
        return "copies (cat/cast)"
    if "reduce" in low:
        return "reductions"
    return "elementwise"


def linear_bytes(np_: int, nv_pad: int, nk: int, max_len: int, cap: int, match: int) -> dict:
    """Bytes of one linear batch, per part.  The sort: nk passes over the
    nm (int32 key, int32 element id) pairs, each read and written once.
    The match: `match`, the bytes match_bytes_ops counts on this batch's
    inputs and outputs, whatever computes it; match_plain adds the
    [max_len, nm] int32 matrices of the plain version (two kill tables,
    four surviving-slot matrices), each written once.  The other parts:
    their inputs read once and outputs written once."""
    nm = np_ + nv_pad
    sort = nk * nm * 8 * 2
    return {
        "batch": 2 * np_ * 2 + (nk + 3) * nv_pad * 4 + sort + (1 + 2 * cap) * 4,
        "sort": np_ * 2 + nk * nv_pad * 4 + sort + nm * 4,
        "lcp_who": nk * nm * 4 + nm * 8 + 3 * nv_pad * 4 + 4 * nm * 4,
        "features": np_ * 4 + np_ * (4 + 4 + 4 + 4 * 1),
        "match": match,
        "match_plain": match + 6 * max_len * nm * 4,
        "commit": np_ * (5 * 4 + 2) + 2 * np_ * 4 + 4,
    }


def match_bytes_ops(n_s: int, window, best_id, best_len, max_len: int) -> tuple[int, int]:
    """Bytes the match must move on these inputs and outputs: lcp, who_len
    and who_kind read at every rank (12 a rank); rank read at the text
    positions only, window and wp read, best_id and best_len written (17 a
    text position); who_id read only at the slots the outputs name,
    counted as the distinct ids of the matched positions, no more than the
    distinct slots read.  Operations: one test for each length a text
    position's window reaches, in each direction; the sweeps' work at each
    rank is left out, so the count is a floor."""
    import torch

    ids = int(torch.unique(best_id[best_len > 0]).numel())
    reach = int(window.clamp(0, max_len).sum())
    return 12 * n_s + 17 * int(window.shape[0]) + 4 * ids, 2 * reach


def linear_match_check(args, max_len: int, label: str) -> dict:
    """The match kernels against match_from_sa_plain on the card, whole
    outputs, exactly, on args (rank, lcp, who_len, who_id, who_kind,
    window, wp); one counted call.  Returns a report row."""
    import torch

    from wordpiece_tpu_torch.ops import linear_match as lm

    launched = lm.match_from_sa.launches
    got = lm.match_from_sa(*args, max_len=max_len)
    want = lm.match_from_sa_plain(*args, max_len=max_len)
    torch.cuda.synchronize()
    if lm.match_from_sa.launches != launched + 1:
        raise AssertionError(f"{label}: not one match call")
    err = exact_diff(got, want, f"{label} match_from_sa")
    return {"input": label, "n_s": int(args[0].shape[0]), "n_text": int(args[5].shape[0]),
            "max_len": max_len, "matched": int((want[1] > 0).sum()), "max_abs_err": err}


# --compare DIR: the order in which the checkout at DIR ("other") and this
# one are timed, so that a drift of the host or the card falls on both.
TURNS = ("other", "this", "this", "other")


def linear_match_compare(other_root: str, card: str, inputs: dict) -> dict:
    """The match kernels of another checkout (its csrc/linear_match.cu,
    the same C interface) beside this one's, on the same inputs: both
    exact against match_from_sa_plain, then each timed by device_ms in
    TURNS with its kernels' device us from a profile.  inputs: name ->
    (args, max_len).  Returns a report line."""
    import torch

    from wordpiece_tpu_torch.ops import cuda_build
    from wordpiece_tpu_torch.ops import linear_match_cuda as lmc
    from wordpiece_tpu_torch.ops.linear_match import match_from_sa_plain

    source = os.path.join(os.path.abspath(other_root), "wordpiece_tpu_torch", "csrc",
                          "linear_match.cu")
    other, _ = cuda_build.build_library(
        source, os.path.join(cuda_build.BUILD_DIR, "liblinear_match_other.so"), force=True)
    libs = {"other": lmc.bind(other), "this": lmc.build()}
    out = {"phase": "linear_match_compare", "card": card, "other": source, "inputs": {}}
    for name, (args, ml) in inputs.items():
        want = match_from_sa_plain(*args, max_len=ml)
        row = {}
        for who, lib in libs.items():
            got = lmc.launch(*args, max_len=ml, lib=lib)
            torch.cuda.synchronize()
            row[f"{who}_max_abs_err"] = exact_diff(got, want, f"{name} {who} linear match")
            _, rows, _ = device_profile(lambda lib=lib: lmc.launch(*args, max_len=ml, lib=lib),
                                        None)
            row[f"{who}_device_us_by_kernel"] = {k: us for k, _, us in rows}
        for who in TURNS:
            lib = libs[who]
            row.setdefault(f"{who}_ms", []).append(
                device_ms(lambda lib=lib: lmc.launch(*args, max_len=ml, lib=lib), 200))
        out["inputs"][name] = row
    return out


# ---- phases 8-10: the fast-stream engine ------------------------------------
ASTRAL_TOKENS = ["𠀀", "𠀁", "##𠀁", "𠀀the", "##𠀂"]


def graph_counts(enc) -> dict:
    """The linear encoder's graph counters, from its StageStats."""
    c = enc.stats.report()["counters"]
    return {k: c.get(k, 0) for k in ("batches_graph", "batches_eager", "graph_captures")}


# A kernel that each hand-kernel wrapper of the linear batch launches once
# a call: a profile counts the batches that ran it, by a graph's replay or
# by a launch, where the wrappers' .launches count only their own calls.
LINEAR_HAND_KERNELS = {"compute_features": "text_features_kernel",
                       "match_from_sa": "sa_match_walk_kernel",
                       "commit_with_positions": "commit_walk_kernel"}


def hand_kernel_runs(rows) -> dict:
    """Runs of the linear batch's hand kernels in device_profile's rows,
    by wrapper name."""
    return {w: sum(c for n, c, _ in rows if k in n) for w, k in LINEAR_HAND_KERNELS.items()}


def wrapper_launches() -> dict:
    """The linear batch's kernel wrappers' .launches, by name."""
    from wordpiece_tpu_torch.dryrun import KERNELS

    return {w: KERNELS[w].launches for w in LINEAR_HAND_KERNELS}


def zero_launches() -> None:
    from wordpiece_tpu_torch.dryrun import KERNELS

    for c in KERNELS.values():
        c.launches = 0


def linear_graph_phase(card: str, data: bytes, lines: list, want, char_vocab) -> dict:
    """Phase 7b (module docstring): LinearEncoder's CUDA graphs against
    launches and the native oracle, on `data` with the vocab of `lines`
    (`want` its oracle ids); the enqueue of a batch both ways."""
    import numpy as np
    import torch

    from wordpiece_tpu_torch.core.vocab import parse_vocab
    from wordpiece_tpu_torch.engine_linear import LinearEncoder, _linear_batch_compact
    from wordpiece_tpu_torch.runtime import loader
    from wordpiece_tpu_torch.utils.profiling import StageStats

    def fresh(v):
        enc = LinearEncoder(v, device="cuda")
        enc.stats = StageStats()
        return enc

    def on_card(a):
        return torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16 else a).cuda()

    # The 10 MB en encode, each batch's codepoints kept.
    vocab = parse_vocab(lines)
    enc = fresh(vocab)
    batches = []
    orig = enc._encode_batch

    def record(cps, as_handle=False):
        batches.append(cps.copy())
        return orig(cps, as_handle)

    enc._encode_batch = record
    zero_launches()
    got = enc.encode_bytes(data)
    del enc._encode_batch
    first = graph_counts(enc)
    calls = wrapper_launches()
    ok = (np.array_equal(got, want) and first["batches_graph"] > 0
          and first["batches_graph"] + first["batches_eager"] == enc.device_batches
          and first["graph_captures"] == len(enc._graphs)
          and all(v == first["batches_eager"] for v in calls.values()))
    # Every batch again, now all replays, each held id for id and position
    # for position to the batch program by launches at its true length,
    # and to the oracle.
    m = enc._merge
    tabs = (m.tok_keys, m.tok_len, m.tok_id, m.tok_kind)
    statics = dict(bits=m.bits, per=m.per, nk=m.nk, max_len=enc.max_len, unk_id=enc._unk_id)
    oracle = loader.VocabHandle(vocab)
    g0, wrong = graph_counts(enc)["batches_graph"], 0
    for cps in batches:
        ids_g, pos_g = enc._fetch_batch(enc._encode_batch(cps, as_handle=True))
        x, c, cap = enc.batch_inputs(cps)
        fused, ids_e, pos_e = _linear_batch_compact(on_card(x), on_card(c), int(cps.shape[0]),
                                                    *tabs, **statics, cap=cap)
        k = int(fused[0])
        wrong += not (k == ids_g.shape[0] and np.array_equal(ids_g, ids_e[:k].cpu().numpy())
                      and np.array_equal(pos_g, pos_e[:k].cpu().numpy())
                      and np.array_equal(ids_g, oracle.encode(cps)))
    replays = graph_counts(enc)["batches_graph"] - g0
    row = {"phase": "linear_graph", "corpus": "en_10MB", "ids": int(got.shape[0]),
           "equal_native_oracle": bool(np.array_equal(got, want)), **first,
           "wrapper_launches": calls,
           "device_batches": enc.device_batches - len(batches), "graphs": len(enc._graphs),
           "keys": sorted(map(list, enc._graphs)), "batches_again": len(batches),
           "replayed_again": replays, "batches_not_equal_launches": wrong}
    emit_json(row)
    if not ok or wrong or replays != len(batches):
        raise AssertionError(f"linear graphs on en 10 MB: {row}")

    # A batch above U+FFFF: the codepoints travel as int32 (another key).
    rng = np.random.default_rng(5)
    words = data[:200_000].decode("utf-8", errors="ignore").split()
    astral = ["\U00020000", "\U00020000\U00020001", "x\U00020001", "\U0001F600"]
    text = " ".join(astral[int(rng.integers(4))] if rng.random() < 0.05 else w for w in words)
    cps = loader.decode_utf8(text.encode()).astype(np.int32)
    a_enc = fresh(parse_vocab(lines + ["\U00020000", "##\U00020001"]))
    a_want = loader.VocabHandle(a_enc.vocab).encode(cps)
    a_got = [a_enc.encode_codepoints(cps) for _ in range(3)]
    a_counts = graph_counts(a_enc)
    a_keys = sorted(map(list, a_enc._graphs))
    a_ok = (int(cps.max()) > 0xFFFF and all(np.array_equal(g, a_want) for g in a_got)
            and any(k[3] == "<i4" for k in a_keys) and a_counts["batches_graph"] > 0)
    row = {"phase": "linear_graph_astral", "codepoints": int(cps.shape[0]),
           "max_codepoint": int(cps.max()), "ids": int(a_want.shape[0]), "keys": a_keys,
           "equal_native_oracle": bool(a_ok), **a_counts}
    emit_json(row)
    if not a_ok:
        raise AssertionError(f"linear graphs above U+FFFF: {row}")

    # A forced overflow on a replay: the char-level vocab, the cap ratio set
    # below its density after the graphs of the small cap were captured.
    head = data[: 1_000_000]
    head = head[: head.rfind(b" ")]
    c_want = loader.VocabHandle(char_vocab).encode(loader.decode_utf8(head))
    o_enc = fresh(char_vocab)
    o_enc._cap_ratio = 0.0001
    o_enc.encode_bytes(head)
    o_enc.stats.reset()
    o_enc._cap_ratio = 0.0001
    f0 = o_enc.full_fetches
    o_got = o_enc.encode_bytes(head)
    o_counts = graph_counts(o_enc)
    reruns = o_enc.full_fetches - f0
    o_ok = (np.array_equal(o_got, c_want) and reruns > 0 and o_counts["batches_graph"] > 0
            and o_counts["batches_eager"] == reruns + o_counts["graph_captures"])
    row = {"phase": "linear_graph_overflow", "corpus": "en_1MB", "vocab": f"char_{char_vocab.size}",
           "ids": int(o_got.shape[0]), "equal_native_oracle": bool(np.array_equal(o_got, c_want)),
           "reruns": reruns, **o_counts}
    emit_json(row)
    if not o_ok:
        raise AssertionError(f"linear graph overflow: {row}")

    # Captures under torch.profiler: a fresh encoder's first encode captures
    # every key inside the profile, its second replays.  Each batch must
    # run each hand kernel once in the trace, read by the kernel's name,
    # and the wrappers must count the batches run by launches alone.
    p_data = data[: data.find(b" ", 2_000_000)]
    p_want = oracle.encode(loader.decode_utf8(p_data))
    p_enc = fresh(vocab)
    prof_rows = {}
    for label in ("captures", "replays"):
        b0, c0 = p_enc.device_batches, graph_counts(p_enc)
        zero_launches()
        out = {}
        wall, rows, busy = device_profile(lambda: out.setdefault("ids", p_enc.encode_bytes(p_data)),
                                          None)
        c1 = graph_counts(p_enc)
        prof_rows[label] = {"batches": p_enc.device_batches - b0,
                            "kernel_runs": hand_kernel_runs(rows),
                            "wrapper_launches": wrapper_launches(),
                            "wall_ms": wall * 1e3,
                            "device_busy_ms": None if busy is None else busy / 1e3,
                            "equal_native_oracle": bool(np.array_equal(out["ids"], p_want)),
                            **{k: c1[k] - c0[k] for k in c1}}
    row = {"phase": "linear_graph_profile", "corpus": "en_2MB", **prof_rows}
    emit_json(row)
    if not all(r["equal_native_oracle"] and r["batches"] > 0
               and all(v == r["batches"] for v in r["kernel_runs"].values())
               and all(v == r["batches_eager"] for v in r["wrapper_launches"].values())
               for r in prof_rows.values()) or \
            prof_rows["captures"]["graph_captures"] < 1 or \
            prof_rows["replays"]["batches_graph"] != prof_rows["replays"]["batches"]:
        raise AssertionError(f"linear graphs under the profiler: {row}")

    # The host's enqueue of one batch (the en first), the card idle before
    # each: a graph's replay against the same program's launches.
    cps = batches[0]
    launches = LinearEncoder(vocab, device="cuda")
    launches._graphs = None  # the stream-launch path
    times = {}
    for label, e in (("graph", enc), ("stream_launches", launches), ("graph_again", enc),
                     ("stream_launches_again", launches)):
        enq, tot = [], []
        ids0 = None
        for _ in range(25):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h = e._encode_batch(cps, as_handle=True)
            t1 = time.perf_counter()
            ids, _ = e._fetch_batch(h)
            t2 = time.perf_counter()
            enq.append(t1 - t0)
            tot.append(t2 - t0)
            ids0 = ids if ids0 is None else ids0
        times[label] = {"enqueue_ms": float(np.median(enq)) * 1e3,
                        "enqueue_and_fetch_ms": float(np.median(tot)) * 1e3,
                        "equal_native_oracle": bool(np.array_equal(ids0, oracle.encode(cps)))}
    row = {"phase": "linear_graph_enqueue", "card": card, "n": int(cps.shape[0]),
           "key": list(max(enc._graphs, key=lambda k: k[0])), "ms": times}
    emit_json(row)
    if not all(t["equal_native_oracle"] for t in times.values()):
        raise AssertionError(f"linear graph enqueue: ids differ: {row}")
    return row


def stream_texts(words: list[str], rng) -> dict:
    """The probe kernel's special inputs as int32 codepoint arrays, from a
    seed: UNK-heavy, astral-plane and punctuation-dense text, a
    2,000-codepoint space-free run, and a single codepoint."""
    import numpy as np

    rare = [chr(int(c)) for c in rng.integers(0x100, 0x250, size=64)]
    astral = [chr(int(c)) for c in rng.integers(0x20000, 0x2A6E0, size=32)] + ["𠀀", "𠀁", "𠀂"]
    punct = list(",.!-'();«»·‐‹") + ["!!", "--", "a-b", "x.y"]
    picked = [words[int(i)] for i in rng.integers(0, len(words), size=20_000)]

    def pick(pool, k):
        return "".join(pool[int(i)] for i in rng.integers(0, len(pool), size=k))

    texts = {
        "unk_heavy": " ".join(
            "".join(c if rng.random() < 0.8 else rare[int(rng.integers(len(rare)))] for c in w)
            for w in picked
        ),
        "astral": " ".join(
            w if rng.random() < 0.5 else pick(astral, int(rng.integers(1, 4))) + w for w in picked
        ),
        "punct_dense": " ".join(pick(punct, int(rng.integers(1, 4))) + w for w in picked),
        "space_free_2000": "".join(picked)[:2000],
        "n_1": "a",
    }
    return {k: np.array([ord(c) for c in v], dtype=np.int32) for k, v in texts.items()}


def stream_check(enc, cps, label: str):
    """The probe kernel against its plain version on the card, on `cps`
    padded to its bucket as the engine pads it: both whole int32[n]
    outputs, exactly, in the tag layout the kernel chooses (read from its
    count of global-tag launches) and with global tags forced.  Returns
    (the kernel's inputs, its statics, a report row)."""
    import torch

    from wordpiece_tpu_torch.engine import pad_codepoints
    from wordpiece_tpu_torch.ops import match_fast as mf
    from wordpiece_tpu_torch.ops.text_features import compute_features

    mp = mf.match_positions
    st = {k: v for k, v in enc._statics.items() if k != "unk_id"}
    cp_pad = torch.from_numpy(pad_codepoints(cps, st["max_len"])).to(enc.device)
    n = cp_pad.shape[0] - st["max_len"]
    feats = compute_features(cp_pad[:n], int(cps.shape[0]), st["max_len"])
    args = (cp_pad, feats.window, feats.wp, enc.table)
    want = mf.match_positions_plain(cp_pad, feats.window, feats.wp, enc.table.rows, **st)
    errs = {}
    for forced in (False, True):
        before = (mp.launches, mp.launches_global)
        got = mp(*args, **st, global_tags=forced)
        layout = "global" if mp.launches_global > before[1] else "shared"
        if mp.launches != before[0] + 1 or (forced and layout != "global"):
            raise AssertionError(f"{label}: not one launch in the expected tag layout")
        if not forced:
            chosen = layout
        torch.cuda.synchronize()
        err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
        if err or not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{label}: match_positions kernel != plain ({layout} tags)")
        errs["forced_global" if forced else chosen] = err
    row = {"input": label, "codepoints": int(cps.shape[0]), "n": n,
           "matched": int((want[1] > 0).sum()), "max_len": st["max_len"],
           "max_probe": st["max_probe"], "log2_size": st["log2_size"], "tags": chosen,
           "pass_order": "longest_first" if st["max_len"] <= 32 else "ascending",
           "max_abs_err_by_layout": errs, "max_abs_err": max(errs.values())}
    return args, st, row


def big_vocab(bert_lines: list, rng, size: int = 150_000):
    """A vocabulary of `size` tokens whose probe table does not fit in
    shared memory (2^20 slots): the bert-shaped lines, then distinct
    seeded tokens of 2-10 Latin and Cyrillic letters, a third of them
    suffixes; and a text of those tokens as words."""
    alphabet = [chr(c) for c in range(ord("a"), ord("z") + 1)] + [chr(c) for c in range(0x430, 0x450)]
    seen = set(bert_lines)
    lines = list(bert_lines)
    words = []
    while len(lines) < size:
        tok = "".join(alphabet[int(i)] for i in rng.integers(0, len(alphabet),
                                                               size=int(rng.integers(2, 11))))
        if rng.random() < 0.33:
            tok = "##" + tok
        elif len(words) < 40_000:
            words.append(tok)
        if tok not in seen:
            seen.add(tok)
            lines.append(tok)
    return lines, " ".join(words)


def stream_bytes_ops(cp_pad, window, wp, table, st) -> tuple[int, int]:
    """Bytes the probe must move: per position its codepoint, window and
    kind read and its two outputs written (n * 17), and the table's
    20-byte rows once.  Operations on these inputs: ~12 per (position,
    length) it visits (two hash multiply-adds, the home slot's mixing,
    multiply and shift, the meta), lengths 1..min(max_len, window), and 5
    per table slot probed there (four compares and the empty test), up to
    the match or the first empty slot."""
    import torch

    from wordpiece_tpu_torch.ops.match_fast import (
        TABLE_FIRST, TABLE_ID, TABLE_K1, TABLE_K2, TABLE_META, probe_keys,
    )

    n = int(window.shape[0])
    mask = (1 << st["log2_size"]) - 1
    k1 = table[:, TABLE_K1].long() & 0xFFFFFFFF
    k2 = table[:, TABLE_K2].long() & 0xFFFFFFFF
    first = cp_pad[:n]
    lengths = torch.zeros((), dtype=torch.int64, device=window.device)
    probes = torch.zeros((), dtype=torch.int64, device=window.device)
    for l, h1, h2, bucket, meta in probe_keys(
        cp_pad, wp, max_len=st["max_len"], log2_size=st["log2_size"],
        mult1=st["mult1"], mult2=st["mult2"],
    ):
        live = window >= l
        lengths += live.sum()
        for p in range(st["max_probe"]):
            slot = (bucket + p) & mask
            probes += live.sum()
            hit = ((k1[slot] == h1) & (k2[slot] == h2) & (table[slot, TABLE_META] == meta)
                   & (table[slot, TABLE_FIRST] == first))
            live = live & ~hit & (table[slot, TABLE_ID] >= 0)
    return n * 17 + int(table.shape[0]) * 20, 12 * int(lengths) + 5 * int(probes)


FEATURE_FIELDS = ("space", "punct", "spacing", "wp", "window", "ss", "wnext")


def features_bytes_ops(n: int) -> tuple[int, int]:
    """Bytes the features must move: the codepoints read (4 a position),
    the four flags (1 each), window (4) and ss, wnext (4 each, n + 1)
    written.  Operations: ~30 a position (the classifiers' 22 compares,
    the window's 5, three running minima)."""
    return 20 * n + 8, 30 * n


def commit_bytes_ops(n: int) -> tuple[int, int]:
    """Bytes the commit must move: best_id, best_len, window (4 each), ss,
    wnext (4 each, n + 1), space, wp (1 each) read; ids, positions (4
    each) and the count written.  Operations: ~18 a position (the step,
    the seeds, the segments, kill and emit)."""
    return 30 * n + 12, 18 * n


def launches_per_call(fn) -> dict:
    """Device work of one call of fn(), read from a CUDA graph of it: its
    kernel, memset and other nodes, counted through the driver
    (cuGraphGetNodes, cuGraphNodeGetType).  The capture also fails on a
    host synchronisation in fn.  (torch.profiler drops some memset records
    once this script has run several profiles, so it cannot count them.)"""
    import ctypes

    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(raw, None, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    if count.value and cu.cuGraphGetNodes(raw, nodes, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    got = {"kernels": 0, "memsets": 0, "other": 0}
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        # CU_GRAPH_NODE_TYPE_KERNEL = 0, CU_GRAPH_NODE_TYPE_MEMSET = 2
        got[{0: "kernels", 2: "memsets"}.get(kind.value, "other")] += 1
    del graph
    torch.cuda.synchronize()
    return got


def exact_diff(got, want, label: str) -> int:
    """max |got - want| over tensors that must be equal (dtype, shape and
    values); raises unless it is 0."""
    err = 0
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{label}: {g.dtype}{list(g.shape)} != {w.dtype}{list(w.shape)}")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    if err:
        raise AssertionError(f"{label}: kernel != plain, max abs err {err}")
    return err


def features_commit_check(x, n_valid: int, max_len: int, matches: dict, unk_id: int,
                          label: str):
    """The features kernel and the commit kernels against their plain
    versions on the card, whole outputs with the padding, exactly: the
    features of x (int32[n]), then the commit of each set of matches
    {name: (best_id, best_len) or a function of the kernel's features},
    both walks to the fixed point.  Each wrapper must launch once a call.
    Returns (a report row, the kernel's features)."""
    import torch

    from wordpiece_tpu_torch.ops import commit as co
    from wordpiece_tpu_torch.ops import text_features as tfo

    launched = tfo.compute_features.launches
    got = tfo.compute_features(x, n_valid, max_len)
    want = tfo.compute_features_plain(x, n_valid, max_len)
    torch.cuda.synchronize()
    if tfo.compute_features.launches != launched + 1:
        raise AssertionError(f"{label}: not one features launch")
    errs = {"features": exact_diff([getattr(got, f) for f in FEATURE_FIELDS],
                                   [getattr(want, f) for f in FEATURE_FIELDS],
                                   f"{label} compute_features")}
    ids, rounds = {}, {}
    for kind, m in matches.items():
        best_id, best_len = m(got) if callable(m) else m
        launched = co.commit_with_positions.launches
        g = co.commit_with_positions(best_id, best_len, got, n_valid, unk_id=unk_id)
        w = co.commit_with_positions_plain(best_id, best_len, want, n_valid, unk_id=unk_id)
        rounds[kind] = co.commit_with_positions_plain.rounds
        torch.cuda.synchronize()
        if co.commit_with_positions.launches != launched + 1:
            raise AssertionError(f"{label}: not one commit call")
        errs[f"commit_{kind}"] = exact_diff(g, w, f"{label} commit {kind}")
        ids[kind] = int(w[2])
    row = {"input": label, "n": int(x.shape[0]), "n_valid": n_valid, "max_len": max_len,
           "ids": ids, "plain_rounds": rounds, "max_abs_err_by_part": errs,
           "max_abs_err": max(errs.values())}
    return row, got


def call_of(rows: list, pieces: list) -> dict:
    """A 10 MB call's kernel numbers from its pieces' rows: the times, the
    bytes, the operations and the bounds summed."""
    keys = [k for k in ("ms", "ms_global_tags", "plain_ms", "bytes", "ops", "bound_ms") if k in rows[0]]
    return {"pieces": pieces, **{k: sum(r[k] for r in rows) for k in keys},
            "bound_by": rows[0]["bound_by"]}


def doc_pieces(data: bytes) -> list:
    """The pieces FastEncoder.encode_bytes cuts `data` into on the card:
    (lo, hi, codepoints) byte ranges, from the decode's count with its
    tiles' prefixes (engine.byte_pieces), or the whole document where it
    holds at most the ladder's cap."""
    import numpy as np
    import torch

    from wordpiece_tpu_torch import engine
    from wordpiece_tpu_torch.ops import utf8_decode as ud

    counted = ud.count_codepoints(torch.from_numpy(np.frombuffer(data, np.uint8).copy()).cuda(),
                                  prefixes=True)
    if counted.n <= engine.LADDER_CAP:
        return [(0, len(data), counted.n)]
    return engine.byte_pieces(data, counted, engine.LADDER_CAP)


def stream_parts(enc, data: bytes):
    """One fast-stream encode of `data`, part by part, the steps of
    FastEncoder.encode_bytes: the bytes into the encoder's pinned slot by
    the host clock, then by CUDA events the H2D, the decode's count with
    the host's read of it (and of the tiles' prefixes where the bytes pass
    the ladder's cap), the cut (`cut`: the card waits for the host), and
    for each piece i (`piece<i>.`; a later one first its bytes' H2D with
    its count, then the read of the piece before's id count with its ids'
    copy) the decode's write, features, match and commit; last the read of
    the last piece's id count, its ids' copy and the copy out
    (`fetch_last`).  Each device part also gives its host time between the
    same two events.  Returns (ids, ms by part)."""
    import torch

    from wordpiece_tpu_torch import engine
    from wordpiece_tpu_torch.ops import commit as commit_ops
    from wordpiece_tpu_torch.ops import match_fast as mf
    from wordpiece_tpu_torch.ops import utf8_decode as ud
    from wordpiece_tpu_torch.ops.text_features import compute_features

    st = dict(enc._statics)
    unk_id = st.pop("unk_id")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = enc._staged(data)
    t1 = time.perf_counter()
    marks = []  # (part, its end's event, the host clock at its record)

    def mark(part):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((part, ev, time.perf_counter()))

    mark("start")
    dev_bytes = host.to(enc.device, non_blocking=True)
    mark("h2d")
    counted = ud.count_codepoints(dev_bytes, prefixes=len(data) > engine.LADDER_CAP)
    del dev_bytes
    mark("decode_count")
    pieces = [(0, len(data), counted.n)]
    if counted.n > engine.LADDER_CAP:
        pieces = engine.byte_pieces(data, counted, engine.LADDER_CAP)
    mark("cut")
    out, end, ran = enc._ids_buffer([k for _, _, k in pieces]), 0, None
    for i, (lo, hi, k) in enumerate(pieces):
        p = f"piece{i}."
        if i:
            counted = ud.count_codepoints(host[lo:hi].to(enc.device, non_blocking=True), expect=k)
            mark(p + "h2d_and_decode_count")
            end = enc._fetch(*ran, out, end)
            ran = None
            ud.check(counted)
            mark(p + "fetch_before")
        elif len(pieces) > 1:
            counted = ud.head(counted, hi, k)
        cp_pad = ud.write_codepoints(counted, engine.bucket_size(k) + st["max_len"])
        del counted
        mark(p + "decode_write")
        feats = compute_features(cp_pad[: cp_pad.shape[0] - st["max_len"]], k, st["max_len"])
        mark(p + "features")
        best_id, best_len = mf.match_positions(cp_pad, feats.window, feats.wp, enc.table, **st)
        mark(p + "match")
        ran = (*commit_ops.commit(best_id, best_len, feats, k, unk_id=unk_id), k)
        del cp_pad, feats, best_id, best_len
        mark(p + "commit")
    got = enc._fetch(*ran, out, end, last=True)
    mark("fetch_last")
    torch.cuda.synchronize()
    parts = {"host_slot": (t1 - t0) * 1e3}
    parts.update({part: a[1].elapsed_time(ev) for a, (part, ev, _) in zip(marks, marks[1:])})
    # A part whose kernel is shorter than the host's enqueue of it shows
    # the enqueue by events: the card waits for the host.
    parts["host_enqueue"] = {part: (at - a[2]) * 1e3 for a, (part, _, at) in zip(marks, marks[1:])}
    return got, parts


def stream_phases(card: str, corpora: dict, goldens: list, words: list, bert_lines_en: list,
                  rng) -> tuple:
    """Phases 8-10 (module docstring).  Returns (the features and commit
    kernels' errors, times at the 10 MB en bucket and main-path launches;
    the probe kernel's entry of the kernels line)."""
    from datetime import timedelta

    import numpy as np
    import torch
    import torch.distributed as dist

    import wordpiece_tpu_torch as wpt
    from wordpiece_tpu_torch import api
    from wordpiece_tpu_torch.bench import stream_cases
    from wordpiece_tpu_torch.cli import main as cli_main
    from wordpiece_tpu_torch.core import unicode as uni
    from wordpiece_tpu_torch.core.vocab import parse_vocab
    from wordpiece_tpu_torch.engine import LADDER_CAP, index_statics, pad_codepoints
    from wordpiece_tpu_torch.ops import commit as co
    from wordpiece_tpu_torch.ops import commit_cuda
    from wordpiece_tpu_torch.ops import match_fast as mf
    from wordpiece_tpu_torch.ops import text_features as tfo
    from wordpiece_tpu_torch.ops import utf8_decode as ud
    from wordpiece_tpu_torch.ops import word_kernel_cuda as wk
    from wordpiece_tpu_torch.ops.match_fast import load_table
    from wordpiece_tpu_torch.parallel import sharding as sh
    from wordpiece_tpu_torch.parallel import vocab_parallel as vp
    from wordpiece_tpu_torch.runtime import loader
    from wordpiece_tpu_torch.utils.profiling import StageStats

    mp = mf.match_positions
    mc = wk.word_match_commit_multi
    fk, ck = tfo.compute_features, co.commit_with_positions
    stream_wrappers = {"compute_features": fk, "match_positions": mp, "commit_with_positions": ck}

    # ---- 8. stream kernel vs plain ------------------------------------------
    encs = {lang: wpt.make_encoder(vocab, "fast-stream", device="cuda")
            for lang, (_, vocab, _) in corpora.items()}
    max_err = 0
    at = {}  # the kernel's inputs at the shapes timed in phase 10
    for lang, enc in encs.items():
        if enc.index.max_probe < 2:
            raise AssertionError(f"{lang}: the bert-shaped table probes no chain (max_probe 1)")
        data = corpora[lang][0]
        head = data[: uni.find_space_cut(data, 1_000_000)]
        cps = uni.decode_utf8(head).astype(np.int32)
        args, st, row = stream_check(enc, cps, f"{lang}_1MB")
        max_err = max(max_err, row["max_abs_err"])
        emit_json({"phase": "stream_kernel_vs_plain", "vocab": "bert_28996", **row})
        if lang == "en":
            at["en_1MB"] = (args, st)
    # The 10 MB en document at the shapes the main path runs it: its pieces.
    data_en = corpora["en"][0]
    cps_en = uni.decode_utf8(data_en).astype(np.int32)
    pieces_en = {f"en_10MB_piece{i}": (lo, hi, k) for i, (lo, hi, k) in enumerate(doc_pieces(data_en))}
    if len(pieces_en) < 2 or max(k for _, _, k in pieces_en.values()) > LADDER_CAP:
        raise AssertionError(f"the 10 MB en document's pieces: {pieces_en}")
    for label, (lo, hi, k) in pieces_en.items():
        cps = uni.decode_utf8(data_en[lo:hi]).astype(np.int32)
        args, st, row = stream_check(encs["en"], cps, label)
        at[label] = (args, st)
        max_err = max(max_err, row["max_abs_err"])
        emit_json({"phase": "stream_kernel_vs_plain", "vocab": "bert_28996", **row})
    special = wpt.make_encoder(parse_vocab(bert_lines_en + ASTRAL_TOKENS), "fast-stream",
                               device="cuda")
    for name, cps in stream_texts(words, rng).items():
        _, _, row = stream_check(special, cps, name)
        max_err = max(max_err, row["max_abs_err"])
        emit_json({"phase": "stream_kernel_vs_plain", "vocab": "bert_28996_plus_astral", **row})
        if name == "astral" and not (cps > 0xFFFF).any():
            raise AssertionError("the astral text has no astral codepoint")
    # A table whose tags do not fit in shared memory (2^20 slots).
    big_lines, big_text = big_vocab(bert_lines_en, rng)
    big = wpt.make_encoder(parse_vocab(big_lines), "fast-stream", device="cuda")
    head = corpora["en"][0][: uni.find_space_cut(corpora["en"][0], 1_000_000)]
    cps = uni.decode_utf8(head + b" " + big_text.encode()).astype(np.int32)
    _, _, row = stream_check(big, cps, "en_1MB_plus_big_vocab_words")
    max_err = max(max_err, row["max_abs_err"])
    emit_json({"phase": "stream_kernel_vs_plain", "vocab": f"big_{len(big_lines)}", **row})
    if row["log2_size"] < 18 or row["tags"] != "global":
        raise AssertionError(f"the big vocab's table (2^{row['log2_size']} slots) "
                             f"kept its tags in {row['tags']} memory")
    # Tokens of 49-90 codepoints: max_len past the kernel's 32-bit mask.
    d_lines, d_text = doubling_vocab(np.random.default_rng(7))
    longv = wpt.make_encoder(parse_vocab(d_lines), "fast-stream", device="cuda")
    _, _, row = stream_check(longv, np.array([ord(c) for c in d_text], dtype=np.int32),
                             "long_tokens")
    max_err = max(max_err, row["max_abs_err"])
    emit_json({"phase": "stream_kernel_vs_plain", "vocab": f"long_tokens_{len(d_lines)}", **row})
    if row["max_len"] <= 32 or row["matched"] == 0:
        raise AssertionError("the long-token vocab did not take the ascending pass")

    # ---- 8b. features and commit kernels vs plain --------------------------
    fc_err = 0
    fc_at = {}  # the two kernels' inputs at the shapes timed in phase 10
    fc_rng = np.random.default_rng(2028)

    def fc_stream(enc, cps, n_valid, label, bucket, given=None):
        """Both kernels against their plain versions on `cps` padded as the
        engine pads it (bucket) or as it is, then max_len zeros: the
        probe kernel's matches and random ones inside the window, or the
        `given` (best_id, best_len)."""
        nonlocal fc_err
        st = {k: v for k, v in enc._statics.items() if k != "unk_id"}
        if bucket:
            cp_np = pad_codepoints(cps, st["max_len"])
        else:
            cp_np = np.concatenate([cps, np.zeros(st["max_len"], dtype=np.int32)])
        cp_pad = torch.from_numpy(cp_np).to(enc.device)
        n = cp_pad.shape[0] - st["max_len"]

        def probe(f):
            return mf.match_positions(cp_pad, f.window, f.wp, enc.table, **st)

        def rand(f):
            got = stream_cases.random_matches(fc_rng, f.window.cpu().numpy())
            return tuple(torch.from_numpy(a).to(enc.device) for a in got)

        matches = ({"probe": probe, "random": rand} if given is None else
                   {"given": tuple(torch.from_numpy(a).to(enc.device) for a in given)})
        row, _ = features_commit_check(cp_pad[:n], n_valid, st["max_len"], matches,
                                       enc._statics["unk_id"], label)
        fc_err = max(fc_err, row["max_abs_err"])
        emit_json({"phase": "features_commit_vs_plain", **row})
        return enc, cp_pad, n, n_valid

    for lang, enc in encs.items():
        data = corpora[lang][0]
        cps = uni.decode_utf8(data[: uni.find_space_cut(data, 1_000_000)]).astype(np.int32)
        got = fc_stream(enc, cps, int(cps.shape[0]), f"{lang}_1MB", True)
        if lang == "en":
            fc_at["en_1MB"] = got
    for label, (lo, hi, k) in pieces_en.items():
        cps = uni.decode_utf8(data_en[lo:hi]).astype(np.int32)
        fc_at[label] = fc_stream(encs["en"], cps, k, label, True)
    cases = {**stream_cases.feature_cases(), **stream_cases.large_cases()}
    for name, (cps, n_valid, _) in cases.items():
        fc_stream(special, cps, n_valid, name, False)
    for name, (cps, n_valid, _, best_id, best_len) in stream_cases.commit_cases().items():
        fc_stream(special, cps, n_valid, name, False, given=(best_id, best_len))

    # ---- 9. stream main path ------------------------------------------------
    mp.launches = mp.launches_global = 0
    fk.launches = ck.launches = 0
    ud.count_codepoints.launches = ud.write_codepoints.launches = 0
    mc.launches = mc.launches_global = wk.compact_from_counts.launches = 0
    calls = pieces = 0
    by_lang = {}
    for lang, enc in encs.items():
        data, _, want = corpora[lang]
        if lang == "en":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
        enc.stats = StageStats()
        got = api._encode_with(enc, data)
        by_lang[lang] = enc.stats.report()["counters"]["stream_pieces"]
        enc.stats = None
        calls += 1
        pieces += by_lang[lang]
        ok = got.dtype == np.int32 and np.array_equal(got, want)
        row = {"phase": "stream_main_path", "corpus": f"{lang}_10MB", "vocab": "bert_28996",
               "ids": int(got.shape[0]), "equal_native_oracle": bool(ok),
               "table_device": str(enc.table.device), "max_len": enc.index.max_len,
               "max_probe": enc.index.max_probe, "log2_size": enc.index.log2_size}
        if lang == "en":
            row.update(peak_allocated_bytes=torch.cuda.max_memory_allocated(),
                       resident_before_bytes=resident)
            peak = row["peak_allocated_bytes"] - resident
        emit_json(row)
        if not ok:
            raise AssertionError(f"fast-stream {lang}: ids differ from the native oracle")
    for name, corpus, lines, ref in goldens:
        got = api._encode_with(wpt.make_encoder(parse_vocab(lines), "fast-stream", device="cuda"),
                               corpus)
        calls += 1
        pieces += 1  # a golden text is far under the ladder's cap
        ok = got.dtype == np.int32 and got.tobytes() == ref.tobytes()
        emit_json({"phase": "stream_golden", "file": name, "ids": int(got.shape[0]),
                   "byte_identical": bool(ok)})
        if not ok:
            raise AssertionError(f"fast-stream {name}: ids differ from the reference stream")
    name, corpus, lines, ref = goldens[0]
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f) for f in ("c.txt", "v.txt", "ids.txt")]
        with open(paths[0], "wb") as f:
            f.write(corpus)
        with open(paths[1], "w") as f:
            f.write("\n".join(lines))
        rc = cli_main(["fast-stream", paths[0], paths[1], "--out-file", paths[2],
                       "--device", "cuda"])
        calls += 1
        pieces += 1
        with open(paths[2]) as f:
            ok = rc == 0 and f.read() == "".join(f"{int(i)} " for i in ref)
    emit_json({"phase": "stream_cli", "file": name, "rc": rc, "equal_reference": bool(ok)})
    if not ok:
        raise AssertionError("the CLI's fast-stream mode: output differs from the reference")
    launches, launches_global = mp.launches, mp.launches_global
    word = (mc.launches, wk.compact_from_counts.launches)
    stream_launches = {"compute_features": fk.launches, "match_positions": launches,
                       "commit_with_positions": ck.launches,
                       "utf8_count": ud.count_codepoints.launches,
                       "utf8_write": ud.write_codepoints.launches}
    emit_json({"phase": "stream_main_path_launches", **stream_launches,
               "match_positions_global_tags": mp.launches_global,
               "encode_calls": calls, "pieces": pieces, "pieces_10MB": by_lang,
               "word_kernels": list(word)})
    # One launch of each a piece; 10 MB en and ru pass the ladder's cap.
    if (set(stream_launches.values()) != {pieces} or pieces <= calls
            or by_lang["en"] != len(pieces_en)):
        raise AssertionError(f"{stream_launches} launches for {pieces} pieces of {calls} "
                             f"fast-stream encodes")
    if launches_global:
        raise AssertionError("the bert-scale stream path read its tags from global memory")
    en_st = encs["en"]._statics
    stream_layout = (f"{'global' if launches_global else 'shared'} tags "
                     f"(en: 2^{en_st['log2_size']} slots), "
                     f"{'longest match first' if en_st['max_len'] <= 32 else 'ascending'}")
    if any(word):
        raise AssertionError(f"the fast-stream path launched the word kernels: {word}")

    # One-rank nccl group, in this process: the sharded stream encoders.
    want_en = corpora["en"][2]
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg", rank=0, world_size=1,
                                timeout=timedelta(seconds=120))
        try:
            before = {k: c.launches for k, c in stream_wrappers.items()}
            enc = sh.ShardedFastEncoder(corpora["en"][1], device="cuda")
            got = enc.encode_codepoints(cps_en)
            ok_1d = np.array_equal(got, want_en)
            grid = sh.make_mesh(1, 1)
            sidx = vp.build_index_sharded(corpora["en"][1], 1)
            shards, lens = sh.shard_codepoints(cps_en, 1)
            ids, counts, total = sh.encode_2d_parallel(
                sh.pad_shards(shards, sidx.max_len), lens, load_table(sidx.tables[0], enc.device),
                mesh=grid, **index_statics(sidx),
            )
            got2 = sh.assemble_ids(ids.cpu().numpy(), counts.cpu().numpy())
            ok_2d = np.array_equal(got2, want_en) and int(total) == want_en.shape[0]
            sharded_launches = {k: c.launches - before[k] for k, c in stream_wrappers.items()}
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
    emit_json({"phase": "stream_sharded", "corpus": "en_10MB", "backend": backend,
               "world_size": 1, "device": str(enc.device), "data_parallel_equal_oracle": ok_1d,
               "grid_2d_equal_oracle": bool(ok_2d), "total": int(total),
               "launches": sharded_launches})
    if not (ok_1d and ok_2d) or set(sharded_launches.values()) != {2}:
        raise AssertionError("the sharded stream encoders on one nccl rank differ from the oracle")

    # ---- 10. stream numbers -------------------------------------------------
    timing = {}
    for key, (args, st) in at.items():
        k_ms = device_ms(lambda: mf.match_positions(*args, **st), 50)
        kg_ms = device_ms(lambda: mf.match_positions(*args, **st, global_tags=True), 50)
        rows_args = (*args[:3], args[3].rows)
        p_ms = cuda_ms(lambda: mf.match_positions_plain(*rows_args, **st), 3)
        nbytes, ops = stream_bytes_ops(*rows_args, st)
        b_ms, b_by = bound_ms(nbytes, ops)
        # Lengths probed per position, and per warp of 32 positions: the
        # kernel's lanes wait for their warp's longest window.
        lengths = args[1].clamp(min=0, max=st["max_len"]).float()
        warp_max = lengths[: lengths.numel() // 32 * 32].view(-1, 32).max(dim=1).values
        timing[key] = {"n": int(args[1].shape[0]), "ms": k_ms, "ms_global_tags": kg_ms,
                       "plain_ms": p_ms, "bytes": nbytes, "ops": ops, "bound_ms": b_ms,
                       "bound_by": b_by, "mean_lengths": float(lengths.mean()),
                       "mean_warp_max_lengths": float(warp_max.mean())}
        if not all(v > 0 for v in (k_ms, kg_ms, p_ms, nbytes, ops)):
            raise AssertionError(f"{key}: a time or a bound term was not measured")
    timing["en_10MB"] = call_of([timing[k] for k in pieces_en], list(pieces_en))
    emit_json({"phase": "stream_kernel_time", "card": card, "launches_per_encode": launches / calls,
               "launches_per_piece": launches / pieces, **timing})

    # The features and commit kernels at the same shapes, the commit on the
    # probe kernel's matches.
    fc_timing = {}
    for key, (enc, cp_pad, n, n_valid) in fc_at.items():
        st = {k: v for k, v in enc._statics.items() if k != "unk_id"}
        unk_id, x = enc._statics["unk_id"], cp_pad[:n]
        feats = fk(x, n_valid, st["max_len"])
        best = mf.match_positions(cp_pad, feats.window, feats.wp, enc.table, **st)
        row = {"n": n, "n_valid": n_valid,
               "features_launches_per_call": launches_per_call(
                   lambda: fk(x, n_valid, st["max_len"])),
               "commit_launches_per_call": launches_per_call(
                   lambda: ck(*best, feats, n_valid, unk_id=unk_id))}
        want_calls = {"features_launches_per_call": {"kernels": 1, "memsets": 1, "other": 0},
                      "commit_launches_per_call": {"kernels": commit_cuda.KERNEL_LAUNCHES,
                                                   "memsets": 1, "other": 0}}
        if any(row[k] != v for k, v in want_calls.items()):
            raise AssertionError(f"{key}: launches a call {row}, expected {want_calls}")
        for part, k_fn, p_fn, (nbytes, ops) in (
            ("features", lambda: fk(x, n_valid, st["max_len"]),
             lambda: tfo.compute_features_plain(x, n_valid, st["max_len"]),
             features_bytes_ops(n)),
            ("commit", lambda: ck(*best, feats, n_valid, unk_id=unk_id),
             lambda: co.commit_with_positions_plain(*best, feats, n_valid, unk_id=unk_id),
             commit_bytes_ops(n)),
        ):
            k_ms = device_ms(k_fn, 50)
            p_ms = cuda_ms(p_fn, 3)
            b_ms, b_by = bound_ms(nbytes, ops)
            row[part] = {"ms": k_ms, "plain_ms": p_ms, "bytes": nbytes, "ops": ops,
                         "bound_ms": b_ms, "bound_by": b_by}
            if not all(v > 0 for v in (k_ms, p_ms, nbytes, ops)):
                raise AssertionError(f"{key} {part}: a time or a bound term was not measured")
        fc_timing[key] = row
    fc_timing["en_10MB"] = {part: call_of([fc_timing[k][part] for k in pieces_en], list(pieces_en))
                            for part in ("features", "commit")}
    emit_json({"phase": "features_commit_time", "card": card, **fc_timing})

    enc_en, data_en = encs["en"], corpora["en"][0]
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        got = api._encode_with(enc_en, data_en)
        runs.append(time.perf_counter() - t0)
    if not np.array_equal(got, want_en):
        raise AssertionError("timed fast-stream en encode: ids differ from the native oracle")
    got, parts = stream_parts(enc_en, data_en)
    if not np.array_equal(got, want_en):
        raise AssertionError("fast-stream en encode by parts: ids differ from the native oracle")
    median_s = float(np.median(runs))
    emit_json({"phase": "stream_e2e", "corpus": "en_10MB", "vocab": "bert_28996", "card": card,
               "seconds": runs, "best_s": min(runs), "median_s": median_s,
               "mb_per_s": len(data_en) / min(runs) / 1e6,
               "median_mb_per_s": len(data_en) / median_s / 1e6, "parts_ms": parts,
               "peak_allocated_bytes_over_resident": peak})

    wall, rows, busy_us = device_profile(lambda: api._encode_with(enc_en, data_en), None)
    classes: dict = {}
    for name, count, us in rows:
        c = classes.setdefault(op_class(name), [0, 0.0])
        c[0] += count
        c[1] += us
    emit_json({"phase": "stream_profile", "corpus": "en_10MB", "card": card,
               "wall_ms": wall * 1e3,
               "device_busy_ms": None if busy_us is None else busy_us / 1e3,
               "device_busy_share": None if busy_us is None else busy_us / 1e3 / (wall * 1e3),
               "by_class_ms": {k: [c, us / 1e3] for k, (c, us) in sorted(classes.items())},
               "device_rows": rows[:25]})
    # Every step a kernel of its own: no torch scan (cummin) and no
    # scatter_reduce left on the path; memsets and copies may remain.
    torch_ops = [r for r in rows if op_class(r[0]) in ("scans (cummax/cummin/cumsum)", "scatters")
                 or any(k in r[0].lower() for k in ("cummin", "scatter"))]
    missing = ({"features kernel", "match_positions kernel", "commit kernels",
                "utf8 decode kernels"} - set(classes))
    if torch_ops or missing:
        raise AssertionError(f"fast-stream profile: torch scans or scatters {torch_ops}, "
                             f"kernels not seen {sorted(missing)}")

    t10 = timing["en_10MB"]
    fc = {"max_err": fc_err, "timing": fc_timing["en_10MB"], "launches": stream_launches}
    return fc, {
        "name": "match_positions",
        "route": "cuda",
        "source": "wordpiece_tpu_torch/csrc/match_fast.cu",
        "replaces": "wordpiece_tpu/ops/match_fast.py:61",
        "layout": stream_layout,
        "launches": launches,
        "max_abs_err": max_err,
        "ms": t10["ms"],
        "plain_ms": t10["plain_ms"],
        "bound_ms": t10["bound_ms"],
        "bound_by": t10["bound_by"],
        "library_ms": None,
    }


def stream_turn(root: str, inputs: str) -> None:
    """One turn of stream_compare, in a process of its own: the fast-stream
    and linear engines of the checkout at `root` on the 10 MB en text,
    vocab and oracle ids that stream_compare wrote to `inputs`, five
    encodes of each after a warm-up (which builds the kernels), then five
    fast-stream encodes by part through that checkout's own
    chip_smoke.stream_parts, so each tree times its own host pass.
    Prints one JSON line."""
    sys.path.insert(0, root)
    import importlib.util

    import numpy as np

    import wordpiece_tpu_torch as wpt
    from wordpiece_tpu_torch import api
    from wordpiece_tpu_torch.core.vocab import parse_vocab

    package = os.path.dirname(os.path.abspath(wpt.__file__))
    if package != os.path.join(os.path.abspath(root), "wordpiece_tpu_torch"):
        raise RuntimeError(f"imported {package}, not the package under {root}")
    spec = importlib.util.spec_from_file_location("turn_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    data = read_bytes(os.path.join(inputs, "text.txt"))
    with open(os.path.join(inputs, "vocab.txt"), encoding="utf-8") as f:
        vocab = parse_vocab(f.read().split("\n"))
    want = np.load(os.path.join(inputs, "oracle.npy"))
    encs = {e: wpt.make_encoder(vocab, e, device="cuda") for e in ("fast-stream", "linear")}
    rates = {}
    for engine, enc in encs.items():
        runs = []
        for i in range(6):
            t0 = time.perf_counter()
            got = api._encode_with(enc, data)
            if i:
                runs.append(time.perf_counter() - t0)
            if not np.array_equal(got, want):
                raise AssertionError(f"{root}: {engine} ids differ from the native oracle")
        rates[engine] = {"seconds": runs, "best_s": min(runs), "median_s": float(np.median(runs)),
                         "mb_per_s": len(data) / min(runs) / 1e6,
                         "median_mb_per_s": len(data) / float(np.median(runs)) / 1e6}
    parts = []
    for _ in range(5):
        got, p = smoke.stream_parts(encs["fast-stream"], data)
        if not np.array_equal(got, want):
            raise AssertionError(f"{root}: fast-stream by parts: ids differ from the oracle")
        p.pop("host_enqueue")
        p["host"] = sum(v for k, v in p.items() if k.startswith("host_"))
        parts.append(p)
    emit_json({"package": package, **rates["fast-stream"], "linear": rates["linear"],
               "parts_min_ms": {k: min(p[k] for p in parts) for k in parts[0]},
               "parts_median_ms": {k: float(np.median([p[k] for p in parts])) for k in parts[0]}})


def stream_compare(other_root: str, card: str, data: bytes, lines: list, want) -> dict:
    """--compare DIR (phase 10): stream_turn of the checkout at DIR and of
    this one, each turn a process of its own, in TURNS, on the same text,
    vocab and oracle ids."""
    import numpy as np

    roots = {"other": os.path.abspath(other_root), "this": ROOT}
    if not os.path.isfile(os.path.join(roots["other"], "chip_smoke.py")):
        raise RuntimeError(f"--compare {other_root}: no chip_smoke.py there")
    turns = []
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "text.txt"), "wb") as f:
            f.write(data)
        with open(os.path.join(tmp, "vocab.txt"), "w", encoding="utf-8") as f:
            f.write("\n".join(lines))
        np.save(os.path.join(tmp, "oracle.npy"), want)
        for who in TURNS:
            turn = (f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke; "
                    f"chip_smoke.stream_turn({roots[who]!r}, {tmp!r})")
            res = subprocess.run([sys.executable, "-c", turn], capture_output=True, text=True,
                                 timeout=600)
            if res.returncode != 0:
                raise RuntimeError(f"stream turn of {roots[who]}: rc {res.returncode}\n"
                                   f"{res.stderr[-3000:]}")
            turns.append({"tree": who, **json.loads(res.stdout.strip().splitlines()[-1])})
    return {"phase": "stream_compare", "card": card, "corpus": "en_10MB",
            "other": roots["other"], "turns": turns}


# ---- phase 10b: the UTF-8 decode on the card ---------------------------------
UTF8_TILE = 4096  # bytes a tile of csrc/utf8_decode.cu; 16 a thread
# Bytes at the edges of the decoder's ranges (tests/test_torch_utf8_decode.py's).
UTF8_EDGE = bytes([0x00, 0x20, 0x41, 0x7F, 0x80, 0x8F, 0x90, 0x9F, 0xA0, 0xBF, 0xC0, 0xC1, 0xC2,
                   0xDF, 0xE0, 0xE1, 0xEC, 0xED, 0xEE, 0xEF, 0xF0, 0xF1, 0xF3, 0xF4, 0xF5, 0xF7,
                   0xF8, 0xFB, 0xFC, 0xFE, 0xFF])
# Characters of each encoded width.
UTF8_CHARS = {1: "az 09.", 2: "éßЖñ߿", 3: "€中ア한\uffff", 4: "\U0001f600\U00020000\U0010ffff"}


def utf8_texts(rng) -> dict:
    """Phase 10b's inputs: uniform and edge-pool bytes at lengths around a
    thread's 16 bytes and the 4,096-byte tile, valid text with a 2-, 3- or
    4-byte sequence across each such edge or cut off by the end there, and
    random valid text of every width over three tiles."""
    import numpy as np

    out = {}
    pool = np.frombuffer(UTF8_EDGE, np.uint8)
    lengths = [1, 2, 3, 4, 15, 16, 17, 18, 19, *range(UTF8_TILE - 3, UTF8_TILE + 4),
               *range(2 * UTF8_TILE - 3, 2 * UTF8_TILE + 4), 3 * UTF8_TILE + 1, (1 << 20) + 3]
    for n in lengths:
        out[f"uniform_{n}"] = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        out[f"edge_{n}"] = pool[rng.integers(0, len(pool), n)].tobytes()
    for edge in (16, 32, UTF8_TILE, 2 * UTF8_TILE, 3 * UTF8_TILE):
        for width in (2, 3, 4):
            seq = UTF8_CHARS[width][0].encode()
            for k in range(1, width):  # the sequence starts k bytes before the edge
                out[f"across_{edge}_w{width}_k{k}"] = b"a" * (edge - k) + seq + b" tail"
                out[f"cut_{edge}_w{width}_k{k}"] = b"a" * (edge - k) + seq[:k]
    chars = [c for group in UTF8_CHARS.values() for c in group]
    out["mixed_valid_3_tiles"] = "".join(rng.choice(chars, 6000)).encode()
    return out


def utf8_check(data: bytes, max_len: int, label: str) -> dict:
    """The decode kernels (count_codepoints, write_codepoints on the card)
    against decode_plain: the count, and the whole int32 output at three
    sizes (the count, one more, the engine's bucket), each written into
    memory the allocator hands back dirty.  Raises unless exact."""
    import numpy as np
    import torch

    from wordpiece_tpu_torch.engine import bucket_size
    from wordpiece_tpu_torch.ops import utf8_decode as ud

    host = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    want = ud.decode_plain(host)
    counted = ud.count_codepoints(host.cuda())
    n = counted.n
    if n != want.shape[0]:
        raise AssertionError(f"{label}: the kernel counted {n} codepoints, the plain {want.shape[0]}")
    err = 0
    for size in sorted({n, n + 1, bucket_size(n) + max_len}):
        torch.full((size,), -7, dtype=torch.int32, device="cuda")  # a dirty block to reuse
        got = ud.write_codepoints(counted, size)
        expect = torch.cat([want, torch.zeros(size - n, dtype=torch.int32)])
        err = max(err, exact_diff([got.cpu()], [expect], f"{label} size {size}"))
    return {"input": label, "bytes": len(data), "codepoints": n, "max_abs_err": err}


def utf8_pieces_check(data: bytes, max_len: int, label: str) -> list:
    """The decode as the main path runs a document past the ladder's cap:
    the count of the whole document with its tiles' prefixes (held to the
    plain count's at each tile's end), then each piece's bucket
    (bucket_size(codepoints) + max_len, written into memory the allocator
    hands back dirty) against decode_plain of the piece's bytes: the first
    piece written from the document's count (utf8_decode.head), each later
    one from its own bytes' count given the cut's (checked after a read).
    Returns a row a piece; raises unless exact."""
    import numpy as np
    import torch

    from wordpiece_tpu_torch import engine
    from wordpiece_tpu_torch.ops import utf8_decode as ud

    def host(b):
        return torch.from_numpy(np.frombuffer(b, np.uint8).copy())

    counted = ud.count_codepoints(host(data).cuda(), prefixes=True)
    tile, prefixes = counted.tiles
    every = ud.count_codepoints(host(data), prefixes=True).tiles[1]  # a tile a byte on the CPU
    ends = np.minimum(np.arange(tile, len(data) + tile, tile), len(data)) - 1
    if not np.array_equal(prefixes, every[ends]):
        raise AssertionError(f"{label}: the count's tile prefixes differ from the plain count's")
    if counted.n <= engine.LADDER_CAP:
        return []
    rows = []
    for i, (lo, hi, k) in enumerate(engine.byte_pieces(data, counted, engine.LADDER_CAP)):
        if i:
            piece = ud.count_codepoints(host(data[lo:hi]).cuda(), expect=k)
            torch.cuda.synchronize()
            ud.check(piece)
        else:
            piece = ud.head(counted, hi, k)
        size = engine.bucket_size(k) + max_len
        torch.full((size,), -7, dtype=torch.int32, device="cuda")  # a dirty block to reuse
        got = ud.write_codepoints(piece, size)
        want = ud.decode_plain(host(data[lo:hi]))
        expect = torch.cat([want, torch.zeros(size - k, dtype=torch.int32)])
        err = exact_diff([got.cpu()], [expect], f"{label} piece {i}")
        rows.append({"input": f"{label}_piece{i}", "bytes": hi - lo, "codepoints": k,
                     "bucket": size, "written_from": "the document's count" if i == 0 else
                     "its own count", "max_abs_err": err})
    return rows


def utf8_phase(card: str, corpora: dict, goldens: list, rng) -> dict:
    """Phase 10b (module docstring).  Returns the decode's entry of the
    kernels line."""
    import numpy as np
    import torch

    import wordpiece_tpu_torch as wpt
    from wordpiece_tpu_torch.core import unicode as uni
    from wordpiece_tpu_torch.core.vocab import parse_vocab
    from wordpiece_tpu_torch.engine import bucket_size
    from wordpiece_tpu_torch.ops import utf8_decode as ud
    from wordpiece_tpu_torch.ops import utf8_decode_cuda as udc

    enc = wpt.make_encoder(corpora["en"][1], "fast-stream", device="cuda")
    max_len = enc._statics["max_len"]
    rows = [utf8_check(data, max_len, name) for name, data in utf8_texts(rng).items()]
    rows += [utf8_check(corpus, max_len, f"golden_{name}") for name, corpus, _, _ in goldens]
    rows += [utf8_check(data, max_len, f"{lang}_10MB") for lang, (data, _, _) in corpora.items()]
    for lang, (data, _, _) in corpora.items():
        rows += utf8_pieces_check(data, max_len, f"{lang}_10MB")
    if not any(r["input"].startswith("en_10MB_piece1") for r in rows):
        raise AssertionError("the 10 MB en document ran as one piece")
    max_err = max(r["max_abs_err"] for r in rows)
    emit_json({"phase": "utf8_vs_plain", "inputs": len(rows), "max_abs_err": max_err,
               "rows": [r for r in rows if r["bytes"] >= 1 << 20 or r["input"].startswith(
                   ("golden", "mixed"))]})

    # The kernels' device time on a 10 MB en call as the main path runs
    # it, behind a spin kernel: the count of the document with its memset,
    # 4-byte copy and the copy of the tiles' prefixes; the first piece's
    # write from it; each later piece's count (with its memset and 4-byte
    # copy) and write, from its own bytes.
    data = corpora["en"][0]
    lib = udc.build()
    stream = torch.cuda.current_stream().cuda_stream
    pieces = doc_pieces(data)
    dev_bytes = [torch.from_numpy(np.frombuffer(data if i == 0 else data[lo:hi], np.uint8).copy())
                 .cuda() for i, (lo, hi, _) in enumerate(pieces)]
    scratch = [ud.count_codepoints(b).state for b in dev_bytes]
    words = torch.zeros(len(pieces), dtype=torch.int32, pin_memory=True)
    tiles = torch.empty(-(-len(data) // int(lib.wp_utf8_tile_bytes())), dtype=torch.int64,
                        pin_memory=True)
    sizes = [bucket_size(k) + max_len for _, _, k in pieces]
    outs = [torch.empty(size, dtype=torch.int32, device="cuda") for size in sizes]

    def count():
        for i, b in enumerate(dev_bytes):
            if lib.wp_utf8_count(b.data_ptr(), b.shape[0], scratch[i].data_ptr(),
                                 words[i:].data_ptr(), stream):
                raise RuntimeError("wp_utf8_count failed")
            if i == 0 and lib.wp_utf8_prefixes(scratch[0].data_ptr(), b.shape[0],
                                               tiles.data_ptr(), stream):
                raise RuntimeError("wp_utf8_prefixes failed")

    def write():
        for i, ((lo, hi, k), b) in enumerate(zip(pieces, dev_bytes)):
            if lib.wp_utf8_write(b.data_ptr(), hi - lo, scratch[i].data_ptr(), k, sizes[i],
                                 outs[i].data_ptr(), stream):
                raise RuntimeError("wp_utf8_write failed")

    def both():
        count()
        write()

    ms = {"count": device_ms(count, 50), "write": device_ms(write, 50), "decode": device_ms(both, 50)}
    for i, (lo, hi, k) in enumerate(pieces):
        want = ud.decode_plain(torch.from_numpy(np.frombuffer(data[lo:hi], np.uint8).copy()))
        if (i and words[i].item() != k) or not torch.equal(outs[i][:k].cpu(), want):
            raise AssertionError(f"the timed decode of piece {i} differs from the plain version")
    n = words[0].item()
    later = sum(hi - lo for lo, hi, _ in pieces[1:])
    nbytes = 2 * len(data) + later + 4 * sum(sizes)
    b_ms, b_by = bound_ms(nbytes, 0)
    plain_ms = cuda_ms(lambda: ud.decode_plain(dev_bytes[0]), 3)
    wall, prof_rows, _ = device_profile(lambda: enc.encode_bytes(data), None)
    timing = {"bytes_in": len(data), "codepoints": n, "pieces": pieces, "buckets": sizes, "ms": ms,
              "bytes": nbytes, "bound_ms": b_ms, "bound_by": b_by,
              "share_of_bound": b_ms / ms["decode"], "plain_ms": plain_ms,
              "encode_profile_rows": prof_rows[:12]}
    emit_json({"phase": "utf8_time", "card": card, "corpus": "en_10MB", **timing})
    del dev_bytes, scratch, outs

    # The whole call, the bytes through the card against the host's decode,
    # pad and pageable copy (encode_codepoints of decode_utf8: the path
    # before the card decoded), in turns: a 10 MB file, a 3,000-byte article.
    article = data[: uni.find_space_cut(data, 3000)]
    calls = {"en_10MB": (data, 5), "article_3KB": (article, 300)}
    compare = {}
    for label, (text, reps) in calls.items():
        ways = {"card_decode": lambda t=text: enc.encode_bytes(t),
                "host_decode": lambda t=text: enc.encode_codepoints(
                    uni.decode_utf8(t).astype(np.int32))}
        if not np.array_equal(ways["card_decode"](), ways["host_decode"]()):
            raise AssertionError(f"{label}: encode_bytes differs from encode_codepoints")
        times = {k: [] for k in ways}
        for turn in ("host_decode", "card_decode", "card_decode", "host_decode") * 2:
            for _ in range(reps):
                t0 = time.perf_counter()
                ways[turn]()
                times[turn].append(time.perf_counter() - t0)
        med = {k: float(np.median(v)) * 1e3 for k, v in times.items()}
        compare[label] = {"bytes": len(text), "median_ms": med,
                          "card_over_host": med["card_decode"] / med["host_decode"]}
    # The card's peak over what it held before, a 10 MB call each way.
    peaks = {}
    for way, fn in (("card_decode", lambda: enc.encode_bytes(data)),
                    ("host_decode", lambda: enc.encode_codepoints(
                        uni.decode_utf8(data).astype(np.int32)))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        peaks[way] = torch.cuda.max_memory_allocated() - resident
    emit_json({"phase": "utf8_call", "card": card, "calls": compare,
               "peak_over_resident_bytes": peaks})
    if peaks["card_decode"] > peaks["host_decode"]:
        raise AssertionError(f"the card's decode raised the call's peak: {peaks}")
    return {
        "name": "utf8_decode",
        "route": "cuda",
        "source": "wordpiece_tpu_torch/csrc/utf8_decode.cu",
        "replaces": "none: the JAX engine decodes on the host (wordpiece_tpu/core/unicode.py)",
        "layout": "2 launches, 1 memset and a 4-byte D2H a decode: count (forward sum scan with "
                  "decoupled look-back over 4,096-byte tiles), the host's read, write (codepoints "
                  "staged in shared memory, zeros to the bucket's end); past the ladder's cap "
                  "the document's count brings its tiles' prefixes, its first piece is written "
                  "from it, each later piece counted and written from its own bytes",
        "max_abs_err": max_err,
        "ms": ms["decode"],
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    }


# ---- phases 11-12: the word kernel split in two, the word sharded paths ------
# A vocabulary whose tables have one row per length, so partitions 1 and 2
# of three hold no slot (tests/test_sharding.py:118's vocab).
TINY_LINES = ["[UNK]", "a", "ab", "abc", "##a", "##ab", "b", "##b", "cd", "##cd", "x"]


def exact_err(got, want, label: str) -> int:
    """0 when the two integer tensors are equal, shape and all; raises
    otherwise."""
    import torch

    if got.shape != want.shape:
        raise AssertionError(f"{label}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if err or not torch.equal(got.to(want.dtype), want):
        raise AssertionError(f"{label}: kernel != plain (max_abs_err {err})")
    return err


def plain_matches(cp, tabs):
    """The plain word_match of one bucket against `tabs`, as int32."""
    import torch

    from wordpiece_tpu_torch.ops.word_kernel import word_match

    kw = {k: v for k, v in tabs.statics.items() if k != "unk_id"}
    bid, blen = word_match(cp, tabs.k1, tabs.k2, tabs.tid, width=int(cp.shape[1]), **kw)
    return bid.to(torch.int32), blen.to(torch.int32)


def plain_packed(cp, tabs):
    """The plain word_match of one bucket against `tabs`, packed."""
    from wordpiece_tpu_torch.ops.word_kernel import pack_matches

    return pack_matches(*plain_matches(cp, tabs), int(cp.shape[1]))


def plain_commit(cp, packed, tabs):
    from wordpiece_tpu_torch.ops.word_kernel import unpack_matches, word_commit

    return word_commit(cp, *unpack_matches(packed), width=int(cp.shape[1]), max_len=tabs.max_len,
                       unk_id=tabs.unk_id)


def max_combine(parts):
    """The partitions' matches (best_id, best_len) of one bucket combined as
    the JAX package combines them, with two pmax: the longest length, then
    the largest id among the partitions that reach it."""
    import torch

    best_len = torch.stack([p[1] for p in parts]).max(dim=0).values
    ids = torch.stack([torch.where(p[1] == best_len, p[0], -1) for p in parts])
    return ids.max(dim=0).values, best_len


def split_bytes_ops(cps, tables, packed) -> dict:
    """Bytes and integer operations of the match and the commit kernels on
    these inputs, counted as kernel_bytes_ops counts the fused kernel's.
    Match: the units, the list offsets, every occupied slot's {k1, k2,
    tid} and the salts read once, one packed int32 match per position
    written once; ~12 operations per length and one compare per occupied
    slot of the list it probes, for EVERY position and every length of its
    window.  Commit: the units read once, the packed matches of the
    positions the walk visits read once (4 bytes each: the kernel loads no
    other), the emit matrices and the counts written once; one class test
    per position and 4 operations per visited position (the load, the
    landing, the rollback's test and the emit)."""
    import torch

    from wordpiece_tpu_torch.ops.word_kernel import (
        _features, _widen, probe_keys, unpack_matches, walk_visited,
    )

    sizes = (tables.slot_off[1:] - tables.slot_off[:-1]).to(torch.int64)
    kw = {k: v for k, v in tables.statics.items() if k != "unk_id"}
    m_bytes = tables.slot_off.numel() * 4 + tables.n_slots * 12 + tables.lane_salts_t.numel() * 4
    c_bytes = 0
    lengths = probes = cells = visits = 0
    for cp, m in zip(cps, packed):
        u, w = cp.shape
        unit_bytes = cp.numel() * cp.element_size()
        wide = _widen(cp, w, tables.max_len)
        pos, space, _, wp, window = _features(wide, w, tables.max_len)
        for l, _, _, lane, in_window in probe_keys(wide, wp, window, width=w, **kw):
            lengths += int(in_window.sum())
            probes += int(torch.where(in_window, sizes[l * 128 + lane], 0).sum())
        cells += u * w
        best_len = unpack_matches(m)[1].long()
        visited = int(walk_visited(pos, space, wp, window, best_len).sum())
        visits += visited
        m_bytes += unit_bytes + u * w * 4
        c_bytes += unit_bytes + visited * 4 + u * w * 4 + u * 4
    return {"match": (int(m_bytes), 12 * lengths + probes),
            "commit": (int(c_bytes), cells + 4 * visits)}


def split_phases(card: str, words: list, host_tables, bert_lines: list, mixed: list,
                 mixed_wants: list, cps_en: list, rng) -> dict:
    """Phase 11 (module docstring).  `mixed` is phase 3's mixed-dtype
    dispatch and `mixed_wants` its plain fused emits; `cps_en` the en first
    dispatch's unit matrices on the card.  Returns the two kernels'
    largest errors and their numbers at the en first dispatch."""
    import torch

    from wordpiece_tpu_torch.bench.collisions import collision_vocab, fp_collisions
    from wordpiece_tpu_torch.core.length_tables import build_length_tables, load_length_tables
    from wordpiece_tpu_torch.core.vocab import parse_vocab
    from wordpiece_tpu_torch.engine_word import WIDTHS, _narrow, compact_cap
    from wordpiece_tpu_torch.ops import word_kernel_cuda as wk
    from wordpiece_tpu_torch.ops.word_kernel import pack_matches, unpack_matches
    from wordpiece_tpu_torch.parallel.word_sharding import partition_tables

    dev = cps_en[0].device
    wm, wc, mc = wk.word_match_packed, wk.word_commit_packed, wk.word_match_commit_multi
    whole = load_length_tables(host_tables, dev)
    parts = {n: [load_length_tables(partition_tables(host_tables, n, v), dev) for v in range(n)]
             for n in (2, 3)}
    tiny = build_length_tables(parse_vocab(TINY_LINES))
    tiny_whole = load_length_tables(tiny, dev)
    tiny_parts = [load_length_tables(partition_tables(tiny, 3, v), dev) for v in range(3)]
    empty = [v for v, t in enumerate(tiny_parts) if t.n_slots == 0]
    if not empty:
        raise AssertionError("no partition of the tiny vocab is empty")
    max_err = {"match": 0, "commit": 0}

    def check_match(cps, tabs, label):
        """The match kernel in both key layouts against the plain
        word_match, packed, whole [U, W] outputs; the pair wrapper once
        against the plain pairs.  Returns the plain packed matches."""
        wants = [plain_packed(cp, tabs) for cp in cps]
        for global_keys in (False, True):
            before = (wm.launches, wm.launches_global)
            got = wm(cps, tabs, global_keys=global_keys)
            if (wm.launches, wm.launches_global) != (before[0] + 1, before[1] + int(global_keys)):
                raise AssertionError(f"{label}: not one match launch in the expected layout")
            torch.cuda.synchronize()
            for g, w in zip(got, wants):
                max_err["match"] = max(max_err["match"], exact_err(g, w, f"{label} packed"))
        for (gi, gl), w in zip(wk.word_match_multi(cps, tabs), wants):
            wi, wl = unpack_matches(w)
            exact_err(gi, wi, f"{label} best_id")
            exact_err(gl, wl, f"{label} best_len")
        return wants

    def check_commit(cps, packed, tabs, label, wants=None):
        """The commit kernel on `packed` against the plain word_commit (or
        `wants`), emits and counts; the pair wrapper once.  Returns the
        emits and counts."""
        if wants is None:
            wants = [plain_commit(cp, m, tabs) for cp, m in zip(cps, packed)]
        want_counts = torch.cat([(w != -2).sum(dim=1, dtype=torch.int32) for w in wants])
        counts = torch.empty(sum(int(cp.shape[0]) for cp in cps), dtype=torch.int32, device=dev)
        before = wc.launches
        got = wc(cps, packed, max_len=tabs.max_len, unk_id=tabs.unk_id, counts=counts)
        if wc.launches != before + 1:
            raise AssertionError(f"{label}: not one commit launch")
        torch.cuda.synchronize()
        for g, w in zip(got, wants):
            max_err["commit"] = max(max_err["commit"], exact_err(g, w, f"{label} emits"))
        exact_err(counts, want_counts, f"{label} counts")
        pairs = wk.word_commit_multi(cps, [unpack_matches(m) for m in packed],
                                     max_len=tabs.max_len, unk_id=tabs.unk_id)
        for g, w in zip(pairs, wants):
            exact_err(g, w, f"{label} emits (pairs)")
        return got, counts

    def combine(per):
        """The partitions' packed matches of each bucket max-combined in
        this process (the arithmetic of word_encode_2d_parallel's
        all_reduce), held equal to the JAX package's two-pmax combine of
        their pairs."""
        out = []
        for b, cp in enumerate(per[0]):
            got = torch.stack([p[b] for p in per]).max(dim=0).values
            jax_way = pack_matches(*max_combine([unpack_matches(p[b]) for p in per]),
                                   int(cp.shape[1]))
            exact_err(got, jax_way, f"bucket {b}: packed max != two-pmax combine")
            out.append(got)
        return out

    # Every width: the five phase-3 matrices as one dispatch, whole table.
    for width in WIDTHS:
        cps = [torch.from_numpy(_narrow(m)).to(dev) for m in unit_matrices(width, words, rng).values()]
        matches = check_match(cps, whole, f"width {width}")
        check_commit(cps, matches, whole, f"width {width}")
        emit_json({"phase": "split_kernels_vs_plain", "tables": "whole", "width": width,
                   "buckets": [list(c.shape) for c in cps], "max_abs_err": 0})

    # The mixed dispatch (four widths, three dtypes, an empty bucket, partial
    # tiles) on the whole table and on every partition of 2 and of 3: the
    # max-combined partitions equal the whole table's matches, and the
    # commit of the combined matches equals the fused kernel's plain emits.
    whole_matches = check_match(mixed, whole, "mixed, whole")
    check_commit(mixed, whole_matches, whole, "mixed, whole", wants=mixed_wants)
    for n, tabs in parts.items():
        combined = combine([check_match(mixed, t, f"mixed, partition {v} of {n}")
                            for v, t in enumerate(tabs)])
        for b, (c, w) in enumerate(zip(combined, whole_matches)):
            exact_err(c, w, f"partitions of {n}, bucket {b}: combined matches")
        check_commit(mixed, combined, whole, f"mixed, {n} partitions combined", wants=mixed_wants)
        emit_json({"phase": "split_kernels_vs_plain", "tables": f"{n}_partitions",
                   "slots": [t.n_slots for t in tabs], "buckets": [list(c.shape) for c in mixed],
                   "combined_equal_whole": True, "max_abs_err": 0})
    tiny_combined = combine([check_match(mixed, t, f"mixed, tiny partition {v}")
                             for v, t in enumerate(tiny_parts)])
    tiny_wants = [plain_emit_of(cp, tiny_whole) for cp in mixed]
    check_commit(mixed, tiny_combined, tiny_whole, "mixed, tiny partitions", wants=tiny_wants)
    emit_json({"phase": "split_kernels_vs_plain", "tables": "tiny_3_partitions",
               "slots": [t.n_slots for t in tiny_parts], "empty_partitions": empty,
               "max_abs_err": 0})

    # Fingerprint collisions: the bert vocab's own at the en first dispatch,
    # then a vocabulary with more, found by a search over random strings;
    # the longest-first match falls back past each.
    real = fp_collisions(cps_en, whole)
    lines_c, tabs_c, found = collision_vocab(bert_lines, cps_en, rng)
    check_match(cps_en, tabs_c, "en first dispatch, collision vocab")
    emit_json({"phase": "split_collisions", "corpus": "en_10MB first dispatch",
               "bert_vocab": {"pairs": real[0], "positions": real[1]},
               "collision_vocab": {"tokens_added": len(lines_c) - len(bert_lines),
                                   "pairs": found[0], "positions": found[1]},
               "max_abs_err": 0})

    # The split pipeline on the en first dispatch: match on every partition,
    # combine, commit, compact; equal to the fused kernel and its compaction.
    n_units = sum(int(c.shape[0]) for c in cps_en)
    cap = compact_cap(n_units)
    fused_want, emits_want = wk.word_match_commit_compact(cps_en, whole, cap=cap)
    for n, tabs in parts.items():
        combined = [torch.stack(ms).max(dim=0).values
                    for ms in zip(*[wm(cps_en, t) for t in tabs])]
        fused = torch.empty(1 + n_units + cap, dtype=torch.int32, device=dev)
        emits = wc(cps_en, combined, max_len=whole.max_len, unk_id=whole.unk_id,
                   counts=fused[1 : 1 + n_units])
        wk.compact_from_counts(emits, fused, cap)
        torch.cuda.synchronize()
        for b, (e, w) in enumerate(zip(emits, emits_want)):
            exact_err(e, w, f"en first dispatch, {n} partitions, bucket {b}")
        total = int(fused_want[0])
        exact_err(fused[: 1 + n_units + min(total, cap)], fused_want[: 1 + n_units + min(total, cap)],
                  f"en first dispatch, {n} partitions: compact vector")
        emit_json({"phase": "split_pipeline_vs_fused", "corpus": "en_10MB first dispatch",
                   "partitions": n, "buckets": [list(c.shape) for c in cps_en], "total": total,
                   "equal_fused": True})

    # The en first dispatch against the whole table (the one partition of
    # a 1 x 1 grid, what the 2-D main path feeds the kernels): whole
    # outputs against the plain versions, then the numbers, with the fused
    # kernel in the same call.
    matches = check_match(cps_en, whole, "en first dispatch, whole")
    _, counts = check_commit(cps_en, matches, whole, "en first dispatch, whole")
    emit_json({"phase": "split_kernels_vs_plain", "tables": "whole",
               "corpus": "en_10MB first dispatch", "buckets": [list(c.shape) for c in cps_en],
               "max_abs_err": 0})
    timing = {
        "match": {"ms": device_ms(lambda: wm(cps_en, whole), 200),
                  "global_keys_ms": device_ms(lambda: wm(cps_en, whole, global_keys=True), 200),
                  "plain_ms": cuda_ms(lambda: [plain_packed(cp, whole) for cp in cps_en], 5)},
        "commit": {"ms": device_ms(lambda: wc(cps_en, matches, max_len=whole.max_len,
                                              unk_id=whole.unk_id, counts=counts), 200),
                   "plain_ms": cuda_ms(lambda: [plain_commit(cp, m, whole)
                                                for cp, m in zip(cps_en, matches)], 5)},
        "fused_ms": device_ms(lambda: mc(cps_en, whole, counts=counts), 200),
    }
    for name, (nbytes, ops) in split_bytes_ops(cps_en, whole, matches).items():
        b_ms, b_by = bound_ms(nbytes, ops)
        timing[name].update(bytes=nbytes, ops=ops, bound_ms=b_ms, bound_by=b_by)
        if not all(timing[name][k] > 0 for k in ("ms", "plain_ms", "bytes", "ops")):
            raise AssertionError(f"{name}: a time or a bound term was not measured")
    emit_json({"phase": "split_kernel_time", "corpus": "en_10MB",
               "shapes": "first dispatch, every non-empty bucket", "card": card,
               "buckets": [{"width": int(c.shape[1]), "units": int(c.shape[0]),
                            "dtype": str(c.dtype)} for c in cps_en], **timing})
    return {"max_err": max_err, "timing": timing}


def plain_emit_of(cp, tabs):
    from wordpiece_tpu_torch.ops.word_kernel import word_match_commit

    return word_match_commit(cp, tabs.k1, tabs.k2, tabs.tid, width=int(cp.shape[1]), **tabs.statics)


def word_sharded_phases(corpora: dict) -> dict:
    """Phase 12 (module docstring): the three sharded word encoders on a
    one-rank nccl group, each a main path of its own, with every launch
    count set to 0 just before it and read just after.  Returns each
    path's launches and dispatches."""
    from datetime import timedelta

    import numpy as np
    import torch.distributed as dist

    from wordpiece_tpu_torch.dryrun import KERNELS, counting_collectives
    from wordpiece_tpu_torch.ops import word_kernel_cuda as wk
    from wordpiece_tpu_torch.parallel.multihost import MultiHostWordEncoder
    from wordpiece_tpu_torch.parallel.sharding import make_mesh
    from wordpiece_tpu_torch.parallel.word_sharding import ShardedWordEncoder

    data, vocab, want = corpora["en"]
    # Each path: its encoder, the kernels it launches once per dispatch,
    # and the collectives it issues per dispatch (None: per encode).
    paths = {
        "data_parallel_1d": (lambda: ShardedWordEncoder(vocab, device="cuda"),
                             {"word_match_commit", "compact"}, 1),
        "grid_2d_1x1": (lambda: ShardedWordEncoder(vocab, mesh=make_mesh(1, 1), device="cuda"),
                        {"word_match", "word_commit", "compact"}, 2),
        "multihost": (lambda: MultiHostWordEncoder(vocab, device="cuda"),
                      {"word_match_commit", "compact"}, None),
    }
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg", rank=0, world_size=1,
                                timeout=timedelta(seconds=120))
        try:
            for name, (make, launched, per_dispatch) in paths.items():
                enc = make()
                inner = enc._inner
                orig = inner._dispatch_buckets
                dispatches = 0

                def counted(mats):
                    nonlocal dispatches
                    dispatches += any(m.shape[0] for m in mats)
                    return orig(mats)

                inner._dispatch_buckets = counted
                for c in KERNELS.values():
                    c.launches = 0
                wk.word_match_commit_multi.launches_global = wk.word_match_packed.launches_global = 0
                with counting_collectives() as issued:
                    if name == "multihost":
                        got, total = enc.encode_local_bytes(data)
                    else:
                        got = enc.encode_bytes(data)
                        total = int(got.shape[0])
                launches = {k: c.launches for k, c in KERNELS.items()}
                launches_global = {"word_match_commit": wk.word_match_commit_multi.launches_global,
                                   "word_match": wk.word_match_packed.launches_global}
                ok = got.dtype == np.int32 and np.array_equal(got, want) and total == want.shape[0]
                emit_json({"phase": "word_sharded", "path": name, "corpus": "en_10MB",
                           "backend": dist.get_backend(), "world_size": 1,
                           "device": str(inner.device), "ids": int(got.shape[0]), "total": total,
                           "equal_native_oracle": bool(ok), "dispatches": dispatches,
                           "launches": launches, "launches_global_keys": launches_global,
                           "collectives": issued, "device_fallbacks": inner.device_fallbacks,
                           "verify_repairs": inner.verify_repairs})
                if not ok:
                    raise AssertionError(f"{name}: ids differ from the native oracle")
                if inner.verify_repairs or inner.device_fallbacks:
                    raise AssertionError(f"{name}: {inner.verify_repairs} units repaired on the "
                                         f"host, {inner.device_fallbacks} fetches rescued")
                expected = {k: (dispatches if k in launched else 0) for k in KERNELS}
                if dispatches < 1 or launches != expected:
                    raise AssertionError(f"{name}: launches {launches}, expected {expected}")
                if per_dispatch is not None and sum(issued.values()) != per_dispatch * dispatches:
                    raise AssertionError(f"{name}: collectives {issued} in {dispatches} dispatches, "
                                         f"expected {per_dispatch} per dispatch")
                out[name] = {"launches": launches, "launches_global": launches_global,
                             "dispatches": dispatches, "collectives": issued}
        finally:
            dist.destroy_process_group()
    return out


def dryrun_phase() -> dict:
    """Phase 13 (module docstring).  Returns each kernel's launches in the
    dry run, summed over rank 0's paths."""
    import torch

    from wordpiece_tpu_torch import dryrun

    n = torch.cuda.device_count()
    t0 = time.perf_counter()
    out = dryrun.dryrun_multichip(n, device="cuda")
    seconds = time.perf_counter() - t0
    lines = {ln["path"]: ln for ln in out["lines"]}
    for path, ln in lines.items():
        if not ln["equal_oracle"] or ln["backend"] != "nccl":
            raise AssertionError(f"dry run {path}: {ln}")
        if ln["verify_repairs"] or ln["device_fallbacks"]:
            raise AssertionError(f"dry run {path}: repaired or rescued on the host")
    if lines["word_1d"]["collectives_per_dispatch"] != 1:
        raise AssertionError(f"dry run word_1d: {lines['word_1d']['collectives']} collectives")
    launches = {k: sum(ln["launches"][k] for ln in lines.values()) for k in dryrun.KERNELS}
    fn, (units, tables) = dryrun.entry()
    got = fn(units, tables)
    torch.cuda.synchronize()
    err = exact_err(got, plain_emit_of(units, tables), "entry step")
    emit_json({"phase": "dryrun_done", "world_size": n, "seconds": seconds,
               "paths": list(lines), "launches": launches,
               "ranks_equal_oracle": [all(r["equal_oracle"] for r in recs) for recs in out["ranks"]],
               "rank_devices": [recs[0]["device"] for recs in out["ranks"]],
               "entry": {"units": list(units.shape), "device": str(units.device),
                         "emitted": int((got != -2).sum()), "max_abs_err": err}})
    return launches


def read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


HARNESS_LANGS = ("en", "ru", "ja", "zh")
HARNESS_ENGINES = ("fast", "fast-stream", "linear", "host")
HARNESS_ITERS = 3


def harness_phase(card: str) -> dict:
    """Phase 14 (module docstring): the cross-engine harness's command on
    the card, every launch count set to 0 just before it and read just
    after.  Returns each kernel's launches in that run."""
    from wordpiece_tpu_torch import api
    from wordpiece_tpu_torch.bench import harness
    from wordpiece_tpu_torch.dryrun import KERNELS
    from wordpiece_tpu_torch.engine_linear import LinearEncoder
    from wordpiece_tpu_torch.engine_word import WordEncoder
    from wordpiece_tpu_torch.utils.profiling import StageStats

    made, ran = [], []
    make_encoder, run = api.make_encoder, harness.run

    def keeping_encoders(vocab, engine="fast", **kw):
        enc = make_encoder(vocab, engine=engine, **kw)
        if engine == "fast-stream":
            enc.stats = StageStats()  # the pieces its encodes ran
        made.append((engine, enc))
        return enc

    def keeping_results(*args, **kw):
        ran.append(run(*args, **kw))
        return ran[-1]

    argv = ["--langs", *HARNESS_LANGS, "--corpus-size", "10", "--iters", str(HARNESS_ITERS),
            "--collect", "--device", "cuda"]
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        api.make_encoder, harness.run = keeping_encoders, keeping_results
        os.chdir(tmp)
        try:
            for c in KERNELS.values():
                c.launches = 0
            t0 = time.perf_counter()
            rc = harness.main(argv)
            seconds = time.perf_counter() - t0
            launches = {k: c.launches for k, c in KERNELS.items()}
            streams = {lang: {e: read_bytes(f"result_{e}_{lang}.txt") for e in HARNESS_ENGINES}
                       for lang in HARNESS_LANGS}
        finally:
            os.chdir(cwd)
            api.make_encoder, harness.run = make_encoder, run
    results, counts = ran[0]
    words = [enc for _, enc in made if isinstance(enc, WordEncoder)]
    linears = [enc for _, enc in made if isinstance(enc, LinearEncoder)]
    stream_encodes = sum(e == "fast-stream" for e, _ in made) * (1 + HARNESS_ITERS)
    stream_pieces = sum(enc.stats.report()["counters"]["stream_pieces"]
                        for e, enc in made if e == "fast-stream")
    lin_batches = sum(enc.device_batches for enc in linears)
    lin_launched = lin_batches - sum(enc.graph_replays for enc in linears)
    equal = {lang: len(set(s.values())) == 1 and
             len({counts[f"{lang}/{e}"] for e in HARNESS_ENGINES}) == 1
             for lang, s in streams.items()}
    emit_json({"phase": "harness", "card": card, "argv": argv, "rc": rc,
               "device": harness.device_label("cuda"), "seconds": results, "counts": counts,
               "streams_equal": equal,
               "sha1": {lang: hashlib.sha1(s["host"]).hexdigest()[:16]
                        for lang, s in streams.items()},
               "encoders": [[e, type(enc).__name__, str(getattr(enc, "device", "host"))]
                            for e, enc in made],
               "verify_repairs": sum(enc.verify_repairs for enc in words),
               "device_fallbacks": sum(enc.device_fallbacks for enc in words),
               "linear_device_batches": [enc.device_batches for enc in linears],
               "linear_graph_replays": [enc.graph_replays for enc in linears],
               "fast_stream_encodes": stream_encodes, "fast_stream_pieces": stream_pieces,
               "launches": launches,
               "wall_s": seconds})
    if rc != 0 or not all(equal.values()):
        raise AssertionError(f"harness: rc {rc}, streams equal by language {equal}")
    off_card = [e for e, enc in made if e != "host" and enc.device.type != "cuda"]
    if len(made) != len(HARNESS_LANGS) * len(HARNESS_ENGINES) or off_card:
        raise AssertionError(f"harness: {len(made)} encoders made, off the card: {off_card}")
    if any(enc.verify_repairs or enc.device_fallbacks for enc in words):
        raise AssertionError("harness: the word engine repaired or rescued on the host")
    if not all(enc.device_batches > 0 for enc in linears):
        raise AssertionError("harness: a linear encoder ran no batch on the card")
    missing = [k for k in ("word_match_commit", "compact", "match_positions", "compute_features",
                           "commit_with_positions", "match_from_sa") if launches[k] < 1]
    if missing or launches["word_match"] or launches["word_commit"]:
        raise AssertionError(f"harness: kernels not launched {missing}, or split kernels "
                             f"launched: {launches}")
    if (launches["word_match_commit"] != launches["compact"]
            or stream_pieces < stream_encodes
            or launches["match_positions"] != stream_pieces
            or launches["match_from_sa"] != lin_launched
            or launches["compute_features"] != stream_pieces + lin_launched
            or launches["commit_with_positions"] != stream_pieces + lin_launched
            or not launches["utf8_count"] == launches["utf8_write"] == stream_pieces):
        raise AssertionError(f"harness: launches {launches} against {stream_pieces} pieces of "
                             f"{stream_encodes} fast-stream encodes and {lin_launched} linear "
                             f"batches run by launches ({lin_batches} in all)")
    return launches


class CountingScalar:
    """A native VocabHandle that counts the units an encoder gives it:
    one a call of encode (the word engine's overflow route) and each unit
    of an encode_units batch (units encoded on the host)."""

    def __init__(self, handle):
        self.handle, self.single, self.batched = handle, 0, 0

    def encode(self, cps):
        self.single += 1
        return self.handle.encode(cps)

    def encode_units(self, data, starts, lens, cap):
        self.batched += int(len(starts))
        return self.handle.encode_units(data, starts, lens, cap)


def stress_cases_of():
    """Phase 15's inputs: (case, text bytes, {sign: lines}, engines), made
    from seed 17 by bench/stress_cases.py."""
    from wordpiece_tpu_torch.bench import stress_cases as sc

    data, pos, neg = sc.spaced(10_000_000)
    yield "spaced_10M", data, {"positive": pos, "negative": neg}, ("fast", "linear", "fast-stream")
    data, pos, neg = sc.single_unit(1_000_000, 30_000)
    yield ("single_unit_1M", data, {"positive": pos, "negative": neg},
           ("fast", "linear", "fast-stream"))
    for text_len, data, pos, neg in sc.mid_scale((100_000, 500_000)):
        yield (f"mid_scale_{text_len}", data, {"positive": pos, "negative": neg},
               ("fast", "fast-stream"))


def stress_commit_check(enc, cps, label: str) -> dict:
    """The features and commit kernels against their plain versions
    (features_commit_check) on a fast-stream encoder's text, padded as the
    engine pads it, with the probe kernel's matches: on one unit as long
    as the text, the longest chain the commit's walk can be given."""
    import numpy as np
    import torch

    from wordpiece_tpu_torch.engine import pad_codepoints
    from wordpiece_tpu_torch.ops import match_fast as mf

    st = {k: v for k, v in enc._statics.items() if k != "unk_id"}
    cp_pad = torch.from_numpy(pad_codepoints(np.asarray(cps, np.int32), st["max_len"]))
    cp_pad = cp_pad.to(enc.device)
    n = cp_pad.shape[0] - st["max_len"]
    row, _ = features_commit_check(
        cp_pad[:n], int(cps.shape[0]), st["max_len"],
        {"probe": lambda f: mf.match_positions(cp_pad, f.window, f.wp, enc.table, **st)},
        enc._statics["unk_id"], label)
    return row


def stress_phase(card: str, cases=None, device="cuda") -> tuple:
    """Phase 15 (module docstring): each case and sign through each of its
    engines against the native oracle, every launch count set to 0 just
    before the encode and read just after; on a text of one unit, the
    features and commit kernels also against their plain versions.
    Returns (each kernel's launches summed over the phase's encodes, the
    largest error of those checks)."""
    import numpy as np
    import torch

    from wordpiece_tpu_torch import api
    from wordpiece_tpu_torch.core import unicode as uni
    from wordpiece_tpu_torch.core.vocab import parse_vocab
    from wordpiece_tpu_torch.dryrun import KERNELS
    from wordpiece_tpu_torch.engine_linear import LinearEncoder
    from wordpiece_tpu_torch.engine_word import WIDTHS
    from wordpiece_tpu_torch.runtime import loader
    from wordpiece_tpu_torch.utils.profiling import StageStats

    total = dict.fromkeys(KERNELS, 0)
    fc_err = 0
    t_phase = time.perf_counter()
    for name, data, signs, engines in (stress_cases_of() if cases is None else cases):
        cps = uni.decode_utf8(data)
        space = np.asarray(uni.is_space(cps))
        edges = np.concatenate([[-1], np.flatnonzero(space), [cps.shape[0]]])
        longest_unit = int(np.diff(edges).max()) - 1
        for sign, lines in signs.items():
            vocab = parse_vocab(lines)
            t0 = time.perf_counter()
            want = loader.VocabHandle(vocab).encode(cps)
            oracle_s = time.perf_counter() - t0
            if vocab.unk_token_id != -1 or want.shape[0] == 0:
                raise AssertionError(f"stress {name} {sign}: unk_id {vocab.unk_token_id}, "
                                     f"{want.shape[0]} oracle ids")
            for engine in engines:
                enc = api.make_encoder(vocab, engine, device=device)
                scalar = None
                if engine in ("fast", "linear"):
                    scalar = enc._scalar = CountingScalar(loader.VocabHandle(vocab))
                if engine in ("linear", "fast-stream"):
                    enc.stats = StageStats()
                for c in KERNELS.values():
                    c.launches = 0
                if device != "cpu":
                    torch.cuda.synchronize()
                ran = None
                if engine == "linear" and device != "cpu":
                    # A graph's replay launches the hand kernels without a
                    # wrapper call: the profile counts their runs by name.
                    out = {}
                    seconds, rows, _ = device_profile(
                        lambda: out.setdefault("ids", api._encode_with(enc, data)), None)
                    got, ran = out["ids"], hand_kernel_runs(rows)
                else:
                    t0 = time.perf_counter()
                    got = api._encode_with(enc, data)
                    if device != "cpu":
                        torch.cuda.synchronize()
                    seconds = time.perf_counter() - t0
                launches = {k: c.launches for k, c in KERNELS.items()}
                for k, v in launches.items():
                    total[k] += v
                ok = got.dtype == np.int32 and np.array_equal(got, want)
                row = {"phase": "stress", "case": name, "sign": sign, "engine": engine,
                       "card": card, "chars": int(cps.shape[0]), "longest_unit": longest_unit,
                       "vocab": vocab.size, "max_len": int(vocab.max_len),
                       "unk_id": vocab.unk_token_id, "ids": int(got.shape[0]),
                       "sha1": hashlib.sha1(got.tobytes()).hexdigest()[:16],
                       "equal_native_oracle": bool(ok), "oracle_s": oracle_s,
                       "seconds": seconds, "launches": launches}
                if engine == "fast":
                    row["routes"] = {"dispatches": launches["word_match_commit"],
                                     "overflow_units": scalar.single,
                                     "host_units": scalar.batched}
                    row.update(verify_repairs=enc.verify_repairs,
                               device_fallbacks=enc.device_fallbacks)
                elif engine == "fast-stream":
                    row["pieces"] = enc.stats.report()["counters"]["stream_pieces"]
                elif engine == "linear":
                    row["routes"] = {"device_batches": enc.device_batches,
                                     "scalar_route_units": scalar.batched,
                                     "full_fetches": enc.full_fetches, **graph_counts(enc),
                                     "kernel_runs": ran}
                emit_json(row)
                if not ok:
                    raise AssertionError(f"stress {name} {sign} {engine}: ids differ from the "
                                         f"native oracle")
                stress_launch_check(name, engine, enc, row, longest_unit, max(WIDTHS),
                                    LinearEncoder.MAX_SLOT_LEN)
                if engine == "fast-stream" and longest_unit == cps.shape[0]:
                    fc_row = stress_commit_check(enc, cps, f"{name}_{sign}")
                    fc_err = max(fc_err, fc_row["max_abs_err"])
                    emit_json({"phase": "features_commit_vs_plain", **fc_row})
    emit_json({"phase": "stress_done", "seconds": time.perf_counter() - t_phase,
               "launches": total, "features_commit_max_abs_err": fc_err})
    return total, fc_err


def stress_launch_check(name, engine, enc, row, longest_unit, widest, max_slot_len) -> None:
    """Phase 15's launch and route checks of one encode (row)."""
    got = row["launches"]
    split = got["word_match"] + got["word_commit"]
    if engine == "fast":
        routes = row["routes"]
        if row["verify_repairs"] or row["device_fallbacks"]:
            raise AssertionError(f"stress {name}: the word engine repaired or rescued: {row}")
        want_zero = ("match_positions", "compute_features", "commit_with_positions",
                     "match_from_sa", "utf8_count", "utf8_write")
        ok = (got["word_match_commit"] == got["compact"] and not split
              and not any(got[k] for k in want_zero))
        # A text of one unit wider than the widest bucket: the overflow route.
        if longest_unit == row["chars"] and longest_unit > widest:
            ok = ok and routes == {"dispatches": 0, "overflow_units": 1, "host_units": 0}
        elif longest_unit <= widest:
            ok = ok and routes["dispatches"] > 0 and routes["overflow_units"] == 0
    elif engine == "linear":
        # Each batch runs each hand kernel once (the profile's count by
        # name); the wrappers count the batches run by launches.
        b = enc.device_batches
        routes = row["routes"]
        ok = (all(got[w] == routes["batches_eager"] for w in LINEAR_HAND_KERNELS)
              and all(v == b for v in routes["kernel_runs"].values())
              and not split and not got["word_match_commit"] and not got["compact"]
              and not got["match_positions"] and not got["utf8_count"]
              and not got["utf8_write"]
              and routes["batches_graph"] + routes["batches_eager"] == b)
        if row["max_len"] > max_slot_len:  # the scalar route
            ok = ok and b == 0 and row["routes"]["scalar_route_units"] > 0
        else:
            ok = ok and b > 0
    else:
        # One launch of each a piece: a document past the ladder's cap runs
        # in pieces, the first written from the document's count.
        ok = (got["compute_features"] == got["match_positions"] == got["commit_with_positions"]
              == got["utf8_count"] == got["utf8_write"] == row["pieces"] >= 1 and not split
              and not got["word_match_commit"] and not got["compact"] and not got["match_from_sa"])
    if not ok:
        raise AssertionError(f"stress {name} {engine}: launches or routes {row}")


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke test of wordpiece_tpu_torch on one GPU")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="also write the profiled encode's Chrome trace to PATH")
    ap.add_argument("--compare", default=None, metavar="DIR",
                    help="also time the checkout at DIR beside this one, in turns: its linear "
                         "match kernels (phase 7) and its fast-stream and linear 10 MB en "
                         "encodes with the fast-stream parts (phase 10)")
    opts = ap.parse_args(argv)
    trace_path, compare = opts.trace, opts.compare

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
    from wordpiece_tpu_torch.ops import commit_cuda as cc
    from wordpiece_tpu_torch.ops import linear_match_cuda as lmc
    from wordpiece_tpu_torch.ops import match_fast_cuda as mfc
    from wordpiece_tpu_torch.ops import text_features_cuda as tfc
    from wordpiece_tpu_torch.ops import utf8_decode_cuda as udc
    from wordpiece_tpu_torch.ops.commit import commit_with_positions
    from wordpiece_tpu_torch.ops.linear_match import match_from_sa, match_from_sa_plain
    from wordpiece_tpu_torch.ops.match_fast import match_positions as mp
    from wordpiece_tpu_torch.ops.text_features import compute_features
    from wordpiece_tpu_torch.ops import word_kernel_cuda as wk
    from wordpiece_tpu_torch.runtime import loader

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
    # One nvcc per source, started together.
    libs = {"word_kernel": wk, "match_fast": mfc, "text_features": tfc, "commit": cc,
            "linear_match": lmc, "utf8_decode": udc}
    with ThreadPoolExecutor(max_workers=len(libs)) as pool:
        for fut in [pool.submit(m.build, force=True) for m in libs.values()]:
            fut.result()
    ptxas = {
        name: [ln.strip() for ln in m.build_log.splitlines()
               if any(k in ln for k in ("registers", "spill", "smem", "Compiling entry"))]
        for name, m in libs.items()
    }
    emit_json({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas})
    if not all(ptxas.values()):
        raise RuntimeError(f"no ptxas report for {[k for k, v in ptxas.items() if not v]}")
    if not loader.available():
        raise RuntimeError("native host runtime did not build")

    # ---- 3. kernels vs plain -----------------------------------------------
    en = make_corpus(10_000_000, lang="en")
    bert_lines_en = make_vocab_bert(en)
    vocab_en = parse_vocab(bert_lines_en)
    host_tables = build_length_tables(vocab_en)
    tables = load_length_tables(host_tables, dev)
    words = en[:400_000].decode("utf-8", errors="ignore").split()
    rng = np.random.default_rng(2024)
    mc = wk.word_match_commit_multi
    max_err = {"match": 0, "compact": 0}

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
        for cap in (total + 7, total, total // 2):
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
            want = plain_emit_of(cp, tables)
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
                   "total": total, "caps": [total + 7, total, total // 2], "max_abs_err": 0})

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
    mixed_wants = [plain_emit_of(cp, tables) for cp in mixed]
    for global_keys in (False, True):
        keys = "global" if global_keys else "shared"
        total = check_dispatch(mixed, mixed_wants, tables, global_keys, f"mixed dispatch, {keys}")
        emit_json({"phase": "mixed_dispatch_vs_plain", "keys": keys,
                   "buckets": [list(m.shape) for m in mixed], "dtypes": dtypes,
                   "total": total, "max_abs_err": 0})

    # The compaction alone, on synthetic emit matrices: many blocks, and
    # back-to-back calls on two streams.
    for row in compact_cases(dev, np.random.default_rng(5)):
        max_err["compact"] = max(max_err["compact"], row["max_abs_err"])
        emit_json({"phase": "compact_cases_vs_plain", **row})

    # ---- 4. main path -----------------------------------------------------
    mc.launches = mc.launches_global = wk.compact_from_counts.launches = mp.launches = 0
    compute_features.launches = commit_with_positions.launches = match_from_sa.launches = 0
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

    corpora = {}  # lang -> (corpus, vocab, oracle ids), reused by phase 6
    for lang in ("en", "ru", "ja", "zh"):
        data = en if lang == "en" else make_corpus(10_000_000, lang=lang)
        vocab = vocab_en if lang == "en" else parse_vocab(make_vocab_bert(data))
        want = loader.VocabHandle(vocab).encode(loader.decode_utf8(data))
        corpora[lang] = (data, vocab, want)
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
    char_want = loader.VocabHandle(char_vocab).encode(loader.decode_utf8(head))
    ok = np.array_equal(got, char_want)
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
    goldens = []  # (file, corpus, vocab lines, reference ids), reused by phase 6
    for path in golden_files:
        z = np.load(path)
        corpus = make_corpus(int(z["corpus_bytes"]), lang=str(z["lang"]))
        lines = make_vocab(corpus, vocab_size=int(z["vocab_size"]))
        if hashlib.sha256(corpus).hexdigest() != str(z["corpus_sha"]):
            raise AssertionError(f"{path}: regenerated corpus differs")
        if hashlib.sha256("\n".join(lines).encode()).hexdigest() != str(z["vocab_sha"]):
            raise AssertionError(f"{path}: regenerated vocab differs")
        goldens.append((os.path.basename(path), corpus, lines, z["ids"].astype(np.int32)))
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
    match_global = mc.launches_global
    emit_json({"phase": "main_path_launches", "word_match_commit": launches["match"],
               "word_match_commit_global_keys": match_global,
               "compact": launches["compact"],
               "dispatches": dispatches + api_launches,
               "per_10MB": main_stats})
    if min(launches.values()) <= 0:
        raise AssertionError("the main path never launched a CUDA kernel")
    if set(launches.values()) != {dispatches + api_launches}:
        raise AssertionError(f"not one launch of each kernel per dispatch: {launches}, "
                             f"{dispatches + api_launches} dispatches")
    if match_global:
        raise AssertionError("the bert-scale main path read its keys from global memory")
    if (mp.launches or compute_features.launches or commit_with_positions.launches
            or match_from_sa.launches):
        raise AssertionError("the word engine's main path launched the stream or linear kernels")

    # ---- 5. numbers -------------------------------------------------------
    timing = {}
    for lang in ("en", "ru", "ja", "zh"):
        tabs = encoders[lang].dtables
        cps = [torch.from_numpy(_narrow(m)).to(dev) for m in captured[lang]]
        shapes = [tuple(c.shape) for c in cps]
        n = sum(u for u, _ in shapes)
        cap = compact_cap(n)
        # Held against the plain versions at exactly these shapes first.
        wants = [plain_emit_of(cp, tabs) for cp in cps]
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
        kp_ms = cuda_ms(lambda: [plain_emit_of(cp, tabs) for cp in cps], 5)
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
            "compact": {"ms": c_ms, "plain_ms": cp_ms,
                        "library_ms": lib_ms, "bytes": cb, "ops": co, "bound_ms": c_bound,
                        "bound_by": c_by},
        }
        if not all(v > 0 for v in (k_ms, kg_ms, c_ms, kp_ms, cp_ms, lib_ms, kb, ko, cb, co)):
            raise AssertionError(f"{lang}: a time or a bound term was not measured")
        if lang == "en":
            # What one dispatch launches on the card: the two word kernels
            # and nothing between them (the scan is inside the compaction).
            _, rows, _ = device_profile(lambda: wk.word_match_commit_compact(cps, tabs, cap=cap),
                                        None)
            launched = {name: count for name, count, _ in rows}
            emit_json({"phase": "dispatch_kernels", "corpus": "en_10MB", "kernels": launched})
            if (len(launched) != 2 or sum(launched.values()) != 2
                    or not any("word_match_commit_kernel" in k for k in launched)
                    or not any("compact_kernel" in k for k in launched)):
                raise AssertionError(f"one dispatch launched {launched}, not the two word kernels")
        emit_json({"phase": "kernel_time", "corpus": f"{lang}_10MB",
                   "shapes": "first dispatch, every non-empty bucket", "card": card,
                   "buckets": [{"width": w, "units": u, "dtype": str(c.dtype)}
                               for (u, w), c in zip(shapes, cps)],
                   "total": total, "cap": cap, **timing[lang]})

    if not np.array_equal(enc_en.encode_bytes(en), want_en):
        raise AssertionError("en encode after the kernel timings: ids differ from the native oracle")

    # Where the device time of one 10 MB en encode goes, and how much of
    # the encode's wall time the card is busy at all.
    wall, rows, busy_us = device_profile(lambda: enc_en.encode_bytes(en), trace_path)
    emit_json({"phase": "profile", "corpus": "en_10MB", "card": card, "wall_ms": wall * 1e3,
               "device_busy_ms": None if busy_us is None else busy_us / 1e3,
               "device_busy_share": None if busy_us is None else busy_us / 1e3 / (wall * 1e3),
               "device_rows": rows, "trace": trace_path})

    # ---- 6. the linear engine's main path ----------------------------------
    from wordpiece_tpu_torch import api
    from wordpiece_tpu_torch.engine_linear import (
        _linear_batch_compact, _widen, neighbour_lcp, sort_elements, who_tables,
    )
    from wordpiece_tpu_torch.bench import linear_cases
    from wordpiece_tpu_torch.ops.suffix_array import lcp_clamped, suffix_array

    mc.launches = mc.launches_global = wk.compact_from_counts.launches = mp.launches = 0
    compute_features.launches = commit_with_positions.launches = match_from_sa.launches = 0
    lin_first: dict = {}

    def lin_recording(enc, lang):
        """Keep each corpus's first batch for phase 7, and hold every
        pipelined dispatch to no host synchronisation: torch's sync debug
        mode warns on each, and any warning fails the run, naming every
        line that synchronised."""
        orig = enc._encode_batch

        def record(cps, as_handle=False):
            if lang is not None and lang not in lin_first:
                lin_first[lang] = cps.copy()
            if not as_handle:
                return orig(cps, as_handle)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    handle = orig(cps, as_handle=True)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            syncs = sorted({f"{w.filename}:{w.lineno}" for w in caught
                            if "called a synchronizing" in str(w.message)})
            if syncs:
                raise AssertionError(f"host synchronisation in a pipelined linear dispatch: {syncs}")
            return handle

        enc._encode_batch = record
        return enc

    lin_enc = {}
    lin_batches = lin_launched = 0  # batches; those run by launches, not replays
    for lang in ("en", "ru", "ja", "zh"):
        data, vocab, want = corpora[lang]
        # The namespace's own cached encoder: made here, so that the
        # recorder sits on it before the user entry point encodes.
        enc = lin_recording(api.linear._encoder(vocab, "cuda"), lang)
        got = wpt.linear.encode_text(data, vocab, device="cuda")
        del enc._encode_batch
        m = enc._merge
        ok = len(got) == want.shape[0] and np.array_equal(np.asarray(got, np.int32), want)
        emit_json({"phase": "linear_main_path", "corpus": f"{lang}_10MB", "vocab": "bert_28996",
                   "ids": len(got), "equal_native_oracle": bool(ok), "device": str(enc.device),
                   "tables_device": str(m.tok_keys.device), "device_batches": enc.device_batches,
                   "full_fetches": enc.full_fetches, "nk": m.nk, "bits": m.bits, "per": m.per,
                   "nv_pad": m.nv_pad, "max_len": enc.max_len})
        if not ok:
            raise AssertionError(f"linear {lang}: ids differ from the native oracle")
        if enc.device.type != "cuda" or m.tok_keys.device.type != "cuda" or enc.device_batches < 1:
            raise AssertionError(f"linear {lang}: the batch program did not run on the card")
        lin_enc[lang] = enc
        lin_batches += enc.device_batches
        lin_launched += enc.device_batches - enc.graph_replays

    for name, corpus, lines, ref in goldens:
        enc = lin_recording(wpt.make_encoder(parse_vocab(lines), "linear", device="cuda"), None)
        got = enc.encode_bytes(corpus)
        ok = got.dtype == np.int32 and got.tobytes() == ref.tobytes()
        emit_json({"phase": "linear_golden", "file": name, "ids": int(got.shape[0]),
                   "byte_identical": bool(ok), "device_batches": enc.device_batches})
        if not ok or enc.device_batches < 1:
            raise AssertionError(f"linear {name}: ids differ from the reference stream")
        lin_batches += enc.device_batches
        lin_launched += enc.device_batches - enc.graph_replays

    # Overflow: the char-level vocabulary emits ~1 id per codepoint, past
    # the compact cap of the first batch.
    enc = lin_recording(wpt.make_encoder(char_vocab, "linear", device="cuda"), None)
    got = enc.encode_bytes(head)
    ok = np.array_equal(got, char_want)
    emit_json({"phase": "linear_overflow", "corpus": "en_3MB", "vocab": f"char_{char_vocab.size}",
               "ids": int(got.shape[0]), "equal_native_oracle": bool(ok),
               "device_batches": enc.device_batches, "full_fetches": enc.full_fetches})
    if not ok or enc.full_fetches < 1:
        raise AssertionError(f"linear char vocab: ok={ok}, full_fetches={enc.full_fetches}")
    lin_batches += enc.device_batches
    lin_launched += enc.device_batches - enc.graph_replays

    # The prefix-doubling fallback (nk > 24); the match's inputs of its
    # first batch are kept for phase 7 (the fallback reads the card back,
    # so no sync check).
    d_lines, d_text = doubling_vocab(np.random.default_rng(7))
    d_vocab = parse_vocab(d_lines)
    enc = d_enc = wpt.make_encoder(d_vocab, "linear", device="cuda")
    d_orig = enc.doubling_inputs

    def d_record(cps):
        inputs = d_orig(cps)
        lin_first.setdefault("doubling", inputs)
        return inputs

    enc.doubling_inputs = d_record
    t0 = time.perf_counter()
    got = enc.encode_bytes(d_text.encode())
    d_s = time.perf_counter() - t0
    del enc.doubling_inputs
    want = loader.VocabHandle(d_vocab).encode(loader.decode_utf8(d_text.encode()))
    ok = enc._merge is None and np.array_equal(got, want)
    emit_json({"phase": "linear_doubling_fallback", "vocab": d_vocab.size, "max_len": enc.max_len,
               "codepoints": len(d_text), "ids": int(got.shape[0]),
               "matched_long": int(((got >= 1) & (got < 1 + len(d_lines) - 801)).sum()),
               "equal_native_oracle": bool(ok), "device_batches": enc.device_batches,
               "seconds": d_s})
    if not ok or enc.device_batches < 1:
        raise AssertionError("linear doubling fallback: ids differ from the native oracle")
    lin_batches += enc.device_batches
    lin_launched += enc.device_batches - enc.graph_replays

    # The MAX_SLOT_LEN scalar route: one token longer than 96 codepoints.
    s_vocab = parse_vocab(bert_lines_en + ["q" * 100])
    s_text = en[:1_000_000] + b" " + b"q" * 100 + b" qq"
    enc = wpt.make_encoder(s_vocab, "linear", device="cuda")
    got = enc.encode_bytes(s_text)
    want = loader.VocabHandle(s_vocab).encode(loader.decode_utf8(s_text))
    ok = np.array_equal(got, want) and bool((got == s_vocab.size - 1).any())
    emit_json({"phase": "linear_scalar_route", "max_len": enc.max_len, "ids": int(got.shape[0]),
               "equal_native_oracle": bool(ok), "device_batches": enc.device_batches})
    if not ok or enc.max_len <= enc.MAX_SLOT_LEN or enc.device_batches != 0:
        raise AssertionError("linear MAX_SLOT_LEN route: wrong ids or a device batch ran")
    word_launches = mc.launches + wk.compact_from_counts.launches
    lin_launches = {"compute_features": compute_features.launches,
                    "match_from_sa": match_from_sa.launches,
                    "commit_with_positions": commit_with_positions.launches}
    emit_json({"phase": "linear_main_path_batches", "device_batches": lin_batches,
               "launched_batches": lin_launched,
               "word_kernel_launches": word_launches, "match_positions_launches": mp.launches,
               **lin_launches})
    if word_launches or mp.launches:
        raise AssertionError("the linear path launched the word engine's or the probe's kernels")
    if set(lin_launches.values()) != {lin_launched}:
        raise AssertionError(f"not one features, match and commit call per linear device "
                             f"batch run by launches: {lin_launches}, {lin_launched} of "
                             f"{lin_batches} batches")

    # ---- 7. linear numbers ----------------------------------------------------
    enc_lin = lin_enc["en"]
    if not np.array_equal(enc_lin.encode_bytes(en), want_en):
        raise AssertionError("linear en encode: ids differ from the native oracle")

    b0 = enc_lin.device_batches
    wall, rows, busy_us = device_profile(lambda: enc_lin.encode_bytes(en), None)
    batches = enc_lin.device_batches - b0
    classes: dict = {}
    for name, count, us in rows:
        c = classes.setdefault(op_class(name), [0, 0.0])
        c[0] += count
        c[1] += us
    kernels = sum(c for n, c, _ in rows if not n.lower().startswith(("memcpy", "memset")))
    scans = [n for n, _, _ in rows if op_class(n).startswith("scans")]
    emit_json({"phase": "linear_profile", "corpus": "en_10MB", "card": card, "wall_ms": wall * 1e3,
               "device_busy_ms": None if busy_us is None else busy_us / 1e3,
               "device_busy_share": None if busy_us is None else busy_us / 1e3 / (wall * 1e3),
               "batches": batches, "kernel_launches_per_batch": kernels / max(batches, 1),
               "by_class_ms": {k: [c, us / 1e3] for k, (c, us) in sorted(classes.items())},
               "device_rows": rows[:25]})
    if scans or "linear match kernels" not in classes:
        raise AssertionError(f"the linear encode ran torch scans {scans} or no match kernel")

    # One batch at the en first batch's shapes, whole and by part, by CUDA
    # events around CUDA graph replays; held to the native oracle first.
    cps = lin_first["en"]
    m = enc_lin._merge
    x_np, c_np, cap = enc_lin.batch_inputs(cps)

    def on_card(a):
        return torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16 else a).to(dev)

    x_t, c_t = on_card(x_np), on_card(c_np)
    n, np_, max_len = int(cps.shape[0]), int(x_np.shape[0]), enc_lin.max_len
    tabs = (m.tok_keys, m.tok_len, m.tok_id, m.tok_kind)
    statics = dict(bits=m.bits, per=m.per, nk=m.nk, max_len=max_len, unk_id=enc_lin._unk_id)

    def run_batch():
        return _linear_batch_compact(x_t, c_t, n, *tabs, **statics, cap=cap)

    fused, ids_d, _ = run_batch()
    count = int(fused[0])
    if not np.array_equal(ids_d[:count].cpu().numpy(), loader.VocabHandle(vocab_en).encode(cps)):
        raise AssertionError("linear en first batch: ids differ from the native oracle")
    xw, cw = _widen(x_t), _widen(c_t)
    keys, sa, rank = sort_elements(xw, m.tok_keys, bits=m.bits, per=m.per, nk=m.nk)
    lcp = neighbour_lcp(keys, sa, bits=m.bits, per=m.per, max_len=max_len)
    who = who_tables(sa, np_, *tabs[1:])
    feats = compute_features(cw, n, max_len)
    match_args = (rank, lcp, *who, feats.window, feats.wp)
    best_m = match_from_sa(*match_args, max_len=max_len)
    # Both kernels against their plain versions at this batch's shapes.
    lin_row, _ = features_commit_check(cw, n, max_len, {"suffix_array": best_m},
                                       enc_lin._unk_id, "linear_en_first_batch")
    emit_json({"phase": "features_commit_vs_plain", **lin_row})

    # The match kernels against their plain version: this batch, the
    # doubling fallback's first batch, the edge cases and 2^20 ranks.
    d_args, d_feats = lin_first["doubling"]
    lm_inputs = [("linear_en_first_batch", match_args, max_len),
                 ("doubling_first_batch", (*d_args, d_feats.window, d_feats.wp), d_enc.max_len)]
    for name, c in [*linear_cases.cases().items(), ("max_s_2^20", linear_cases.max_s_case())]:
        lm_inputs.append((name, [torch.from_numpy(c[k]).to(dev) for k in linear_cases.FIELDS],
                          c["max_len"]))
    lm_err = 0
    for name, args, ml in lm_inputs:
        row = linear_match_check(args, ml, name)
        lm_err = max(lm_err, row["max_abs_err"])
        emit_json({"phase": "linear_match_vs_plain", **row})
    lm_nodes = launches_per_call(lambda: match_from_sa(*match_args, max_len=max_len))
    if lm_nodes != {"kernels": lmc.KERNEL_LAUNCHES, "memsets": lmc.MEMSETS, "other": 0}:
        raise AssertionError(f"one match call is {lm_nodes}, not {lmc.KERNEL_LAUNCHES} kernels "
                             f"and {lmc.MEMSETS} memsets")
    # Timed at the en first batch (plain version as a graph) and at 2^20
    # ranks, max_len 96 (plain version by events: 38 ms a call).
    _, max_s_args, max_s_len = lm_inputs[-1]
    lm_times = {}
    for name, args, ml, plain_ms in (
        ("linear_en_first_batch", match_args, max_len, graph_ms),
        ("max_s_2^20", max_s_args, max_s_len, lambda fn, n: cuda_ms(fn, min(n, 3))),
    ):
        def call(args=args, ml=ml):
            return match_from_sa(*args, max_len=ml)

        _, rows, _ = device_profile(call, None)
        nb, no = match_bytes_ops(int(args[0].shape[0]), args[5], *call(), ml)
        bound, by = bound_ms(nb, no)
        lm_times[name] = {
            "ms": device_ms(call, 200),
            "plain_ms": plain_ms(lambda args=args, ml=ml: match_from_sa_plain(*args, max_len=ml),
                                 20),
            "bytes": nb, "ops": no, "bound_ms": bound, "bound_by": by,
        }
        emit_json({"phase": "linear_match_time", "input": name, "card": card,
                   "kernel_launches": lmc.KERNEL_LAUNCHES, "graph_nodes_per_call": lm_nodes,
                   "device_us_by_kernel": {k: us for k, _, us in rows},
                   "n_s": int(args[0].shape[0]), "n_text": int(args[5].shape[0]), "max_len": ml,
                   **lm_times[name]})
    lm_timing = lm_times["linear_en_first_batch"]
    if compare:
        emit_json(linear_match_compare(compare, card, {
            "linear_en_first_batch": (match_args, max_len),
            "max_s_2^20": (max_s_args, max_s_len)}))
    parts = {
        "batch": run_batch,
        "sort": lambda: sort_elements(xw, m.tok_keys, bits=m.bits, per=m.per, nk=m.nk),
        "lcp_who": lambda: (neighbour_lcp(keys, sa, bits=m.bits, per=m.per, max_len=max_len),
                            who_tables(sa, np_, *tabs[1:])),
        "features": lambda: compute_features(cw, n, max_len),
        "match": lambda: match_from_sa(*match_args, max_len=max_len),
        "match_plain": lambda: match_from_sa_plain(*match_args, max_len=max_len),
        "commit": lambda: commit_with_positions(*best_m, feats, n, unk_id=enc_lin._unk_id),
    }
    part_ms = {name: graph_ms(fn, 20) for name, fn in parts.items()}
    part_launches = {}  # kernel launches of one call, from its profile
    for name, fn in parts.items():
        _, rows, _ = device_profile(fn, None)
        part_launches[name] = sum(c for k, c, _ in rows
                                  if not k.lower().startswith(("memcpy", "memset")))
    # The same whole batch by events around plain stream launches (no
    # graph): the host's enqueue is then part of what the events see.
    part_ms["batch_stream_launches"] = cuda_ms(run_batch, 5)
    # The fallback's suffix array and LCP over this batch's S (text · vocab
    # tail): their exit test reads the card once per round, so the events
    # also take in those host round trips.
    s_dev = torch.from_numpy(enc_lin.doubling_string(cps)).to(dev)
    part_ms["suffix_array_lcp"] = cuda_ms(
        lambda: lcp_clamped(s_dev, suffix_array(s_dev)[0], clamp=max_len), 3
    )
    nbytes = linear_bytes(np_, m.nv_pad, m.nk, max_len, cap, lm_timing["bytes"])
    nbytes["suffix_array_lcp"] = int(s_dev.numel()) * 4 * 4
    emit_json({"phase": "linear_batch_time", "corpus": "en_10MB", "card": card,
               "shapes": {"n": n, "np": np_, "nm": np_ + m.nv_pad, "nk": m.nk, "max_len": max_len,
                          "cap": cap, "count": count,
                          "s_doubling": int(s_dev.numel())},
               "ms": part_ms, "launches": part_launches,
               "batch_graph_nodes": launches_per_call(run_batch), "bytes": nbytes,
               "bound_ms": {k: v / HBM_BYTES_PER_S * 1e3 for k, v in nbytes.items()}})

    # ---- 7b. the linear engine's CUDA graphs -----------------------------------------
    linear_graph_phase(card, en, bert_lines_en, want_en, char_vocab)

    # ---- 8-10. the fast-stream engine --------------------------------------------
    fc, stream_kernel = stream_phases(card, corpora, goldens, words, bert_lines_en,
                                      np.random.default_rng(2026))
    if compare:
        emit_json(stream_compare(compare, card, corpora["en"][0], bert_lines_en,
                                 corpora["en"][2]))
    utf8_kernel = utf8_phase(card, corpora, goldens, np.random.default_rng(2029))

    # ---- 11-12. the word kernel split in two; the word sharded paths -------
    cps_en = [torch.from_numpy(_narrow(m)).to(dev) for m in captured["en"]]
    split = split_phases(card, words, host_tables, bert_lines_en, mixed, mixed_wants, cps_en,
                         np.random.default_rng(2027))
    sharded = word_sharded_phases(corpora)

    # ---- 13. the dry run ----------------------------------------------------
    dry = dryrun_phase()

    # ---- 14. the cross-engine harness ------------------------------------------
    del corpora, captured, goldens
    hns = harness_phase(card)

    # ---- 15. the reference's stress configurations -----------------------------
    stress, stress_fc_err = stress_phase(card)

    emit_json({"phase": "done", "seconds": time.perf_counter() - t_start})
    t_en = timing["en"]
    emit_json({"kernels": [
        {
            "name": "word_match_commit",
            "route": "cuda",
            "source": "wordpiece_tpu_torch/csrc/word_kernel.cu",
            "replaces": "wordpiece_tpu/ops/word_kernel_pallas.py:68",
            "layout": "global keys" if match_global else "shared keys",
            "launches": launches["match"],
            "max_abs_err": max_err["match"],
            "ms": t_en["match"]["ms"],
            "plain_ms": t_en["match"]["plain_ms"],
            "bound_ms": t_en["match"]["bound_ms"],
            "bound_by": t_en["match"]["bound_by"],
            "library_ms": None,
            "dryrun_launches": dry["word_match_commit"],
            "harness_launches": hns["word_match_commit"],
            "stress_launches": stress["word_match_commit"],
        },
        {
            "name": "compact_from_counts",
            "route": "cuda",
            "source": "wordpiece_tpu_torch/csrc/word_kernel.cu",
            "replaces": "wordpiece_tpu/ops/word_kernel_pallas.py:349",
            "layout": "one cooperative launch, scan inside",
            "launches": launches["compact"],
            "max_abs_err": max_err["compact"],
            "ms": t_en["compact"]["ms"],
            "plain_ms": t_en["compact"]["plain_ms"],
            "bound_ms": t_en["compact"]["bound_ms"],
            "bound_by": t_en["compact"]["bound_by"],
            "library_ms": t_en["compact"]["library_ms"],
            "dryrun_launches": dry["compact"],
            "harness_launches": hns["compact"],
            "stress_launches": stress["compact"],
        },
        {**stream_kernel, "dryrun_launches": dry["match_positions"],
         "harness_launches": hns["match_positions"],
         "stress_launches": stress["match_positions"]},
        {**utf8_kernel, "launches": fc["launches"]["utf8_count"],
         "dryrun_launches": dry["utf8_count"],
         "harness_launches": hns["utf8_count"], "stress_launches": stress["utf8_count"]},
        *({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "layout": layout,
            "launches": fc["launches"][name],
            "max_abs_err": max(fc["max_err"], lin_row["max_abs_err"], stress_fc_err),
            "ms": fc["timing"][part]["ms"],
            "plain_ms": fc["timing"][part]["plain_ms"],
            "bound_ms": fc["timing"][part]["bound_ms"],
            "bound_by": fc["timing"][part]["bound_by"],
            "library_ms": None,
            "dryrun_launches": dry[name],
            "harness_launches": hns[name],
            "stress_launches": stress[name],
        } for name, part, source, replaces, layout in (
            ("compute_features", "features", "wordpiece_tpu_torch/csrc/text_features.cu",
             "wordpiece_tpu/ops/text_features.py:90",
             "one launch, 4,096-position tiles (2,048 below 2^19 positions) staged in shared "
             "memory, reverse min scan of three flags with decoupled look-back"),
            ("commit_with_positions", "commit", "wordpiece_tpu_torch/csrc/commit.cu",
             "wordpiece_tpu/ops/commit.py:49",
             f"{cc.KERNEL_LAUNCHES} launches a call, walked to the fixed point: a tile-local walk "
             "(doubling in shared memory, one carry a tile), the emit (forward sum scan with "
             "decoupled look-back), the fill"),
        )),
        {
            "name": "match_from_sa",
            "route": "cuda",
            "source": "wordpiece_tpu_torch/csrc/linear_match.cu",
            "replaces": "wordpiece_tpu/ops/linear_match.py:87",
            "layout": f"{lmc.KERNEL_LAUNCHES} launches a call, {lmc.MEMSETS} memsets: a "
                      "bitset of surviving lengths a rank and sweep (<= 3 words a kind), "
                      f"scanned by its run summary over lanes, warps and {lmc.TILE}-rank "
                      "tiles (tiles, carry, walk); q from push bit rows or the carried "
                      "latest push; no loop over lengths, no atomics",
            "launches": lin_launches["match_from_sa"],
            "max_abs_err": lm_err,
            "ms": lm_timing["ms"],
            "plain_ms": lm_timing["plain_ms"],
            "bound_ms": lm_timing["bound_ms"],
            "bound_by": lm_timing["bound_by"],
            "library_ms": None,
            "dryrun_launches": dry["match_from_sa"],
            "harness_launches": hns["match_from_sa"],
            "stress_launches": stress["match_from_sa"],
        },
        *({
            "name": name,
            "route": "cuda",
            "source": "wordpiece_tpu_torch/csrc/word_kernel.cu",
            "replaces": replaces,
            "layout": layout,
            "launches": sharded["grid_2d_1x1"]["launches"][name],
            "max_abs_err": split["max_err"][part],
            "ms": split["timing"][part]["ms"],
            "plain_ms": split["timing"][part]["plain_ms"],
            "bound_ms": split["timing"][part]["bound_ms"],
            "bound_by": split["timing"][part]["bound_by"],
            "library_ms": None,
            "dryrun_launches": dry[name],
            "harness_launches": hns[name],
            "stress_launches": stress[name],
        } for name, part, replaces, layout in (
            ("word_match", "match", "wordpiece_tpu/ops/word_kernel.py:77",
             f"{'global' if sharded['grid_2d_1x1']['launches_global']['word_match'] else 'shared'}"
             " keys, every position, longest first, one position a lane, dense tiles, packed out"),
            ("word_commit", "commit", "wordpiece_tpu/ops/word_kernel.py:148",
             "walk over packed matches in shared memory, 128-position tiles"),
        )),
    ]})
    print(card, flush=True)
    emit_json({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                      "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

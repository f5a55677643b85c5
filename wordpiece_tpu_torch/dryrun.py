"""The port's entry points: the one-dispatch forward step and the
multi-process dry run.  The counterpart of __graft_entry__.py.

    python -m wordpiece_tpu_torch.dryrun --devices N [--device cuda|cpu]

entry() returns the word engine's one-dispatch step (the match+commit
kernel on one bucket of the demo vocabulary's units) with its inputs.

dryrun_multichip() starts one process per rank: on the card, rank r runs on
cuda:r with nccl; with device="cpu", on the CPU with gloo.  It never slides
from one to the other: more ranks than cards raises before any process
starts.  The JAX dry run fakes its devices (a virtual CPU mesh) and
simulates two processes inside one; here every rank is a real process
(multiprocessing spawn, a file rendezvous in a temporary directory).  Each
rank runs, in order, and holds against the native oracle:

 1. the stream engine on the demo text: a (n/2) x 2 grid
    (encode_2d_parallel) where n >= 4 is even, else 1-D encode_data_parallel;
    on the card the features, probe and commit kernels launch once each;
 2. the word engine on the demo text: the 1-D ShardedWordEncoder, and on a
    (n/2) x 2 grid (the split kernels) where n >= 4 is even;
 3. at scale: the 1-D ShardedWordEncoder on a 4.5 MB corpus with an 8k
    vocab and a 5,000-codepoint space-free run (uneven shards), with the
    rows each rank holds per width bucket of the first dispatch
    (parallel/word_sharding.data_slices);
 4. multi-process: MultiHostWordEncoder, each rank encoding its own
    whitespace-safe byte range of the at-scale corpus file; the all-reduced
    total equals the oracle's length for the whole corpus.

Each path prints one JSON line (rank 0 writes it): the world size, backend
and grid, the ids and whether they equal the oracle, the dispatches, the
torch.distributed collectives and kernel launches of the encode,
verify_repairs and device_fallbacks, the encode's wall time and, on CUDA,
the cards' name and power limit.  A rank that raises, or a set of ranks
that outlives DEADLINE_S, is killed, and the parent raises with the
ranks' stderr (torch.multiprocessing.start_processes supervises them).
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .bench.corpus import make_corpus, make_vocab
from .core import unicode as uni
from .core.length_tables import build_length_tables, load_length_tables
from .core.oracle import encode_oracle
from .core.vocab import Vocabulary, build_index, parse_vocab
from .engine import index_statics
from .engine_word import resolve_device
from .ops import commit as commit_ops
from .ops import commit_cuda as cc
from .ops import linear_match
from .ops import match_fast as mf
from .ops import match_fast_cuda as mfc
from .ops import text_features as tf
from .ops import text_features_cuda as tfc
from .ops import utf8_decode as ud
from .ops import word_kernel_cuda as wk
from .parallel.multihost import MultiHostWordEncoder, file_shard_bounds, initialize_distributed
from .parallel.sharding import (
    assemble_ids, encode_2d_parallel, encode_data_parallel, make_mesh, pad_shards, rank_device,
    shard_codepoints,
)
from .parallel.vocab_parallel import build_index_sharded
from .parallel.word_sharding import ShardedWordEncoder, data_slices
from .runtime import loader

DEMO_TEXT = ("the quick brown fox jumps over the lazy dog " * 30).encode()
AT_SCALE_BYTES = 4_500_000
DEADLINE_S = 600.0  # for the whole set of ranks, start-up included

COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor", "broadcast",
               "reduce_scatter", "reduce_scatter_tensor", "all_to_all", "barrier")
# Each kernel wrapper, by the name the kernels line of chip_smoke.py gives it.
KERNELS = {"word_match_commit": wk.word_match_commit_multi, "compact": wk.compact_from_counts,
           "word_match": wk.word_match_packed, "word_commit": wk.word_commit_packed,
           "match_positions": mf.match_positions, "compute_features": tf.compute_features,
           "commit_with_positions": commit_ops.commit_with_positions,
           "match_from_sa": linear_match.match_from_sa,
           "utf8_count": ud.count_codepoints, "utf8_write": ud.write_codepoints}
# The stream path's kernels, each once an encode.
STREAM_KERNELS = ("compute_features", "match_positions", "commit_with_positions")


def _demo_lines() -> list[str]:
    lines = [
        "[PAD]",
        "[UNK]",
        "[CLS]",
        "[SEP]",
        "the",
        "quick",
        "brown",
        "fox",
        "jump",
        "##s",
        "##ed",
        "##ing",
        "over",
        "lazy",
        "dog",
        "##e",
        "##r",
        "t",
        "th",
        "qu",
        "##ick",
        "a",
        "an",
        "and",
        "-",
        ",",
        ".",
    ] + [c for c in "bcdefghijklmnopqrstuvwxyz"] + ["##" + c for c in "abcdefghijklmnopqrstuvwxyz"]
    # Dedupe (keep first occurrence): duplicate lines are out of contract
    # (the reference's verifyVocab rejects them).
    return list(dict.fromkeys(lines))


def _demo_vocab() -> Vocabulary:
    return parse_vocab(_demo_lines())


def _step(units: torch.Tensor, tables) -> torch.Tensor:
    """One dispatch of one bucket: emit int32[U, W] (a token id per
    emitting position, -2 elsewhere); on CUDA tensors one launch of the
    match+commit kernel."""
    return wk.word_match_commit_multi([units], tables)[0]


def entry(device="cuda"):
    """(fn, example_args): the port's one-dispatch forward step of the word
    engine on `device`: fn(units, tables) is word_match_commit_multi on the
    demo vocabulary's length tables and a 512 x 15 unit matrix (the JAX
    entry's, without its max_len columns of space padding: the port's
    kernel reads columns past the width as space).  Raises when CUDA is
    asked for and absent."""
    dev = resolve_device(device)
    tables = load_length_tables(build_length_tables(_demo_vocab()), dev)
    words = ("the quick brown fox jumps over the lazy dog and a tiger".split()) * 40
    width = 15
    mat = np.full((512, width), 32, dtype=np.int32)
    for i, w in enumerate(words[:512]):
        mat[i, : len(w)] = [ord(c) for c in w]
    return _step, (torch.from_numpy(mat).to(dev), tables)


def at_scale_corpus() -> bytes:
    """make_corpus(AT_SCALE_BYTES), a space, a 5,000-codepoint space-free
    run (it lands in one shard), a space and the corpus's first 1,000
    bytes."""
    corpus = make_corpus(AT_SCALE_BYTES)
    return corpus + b" " + b"q" * 5000 + b" " + corpus[:1000]


def card_lines(n: int) -> list[str] | None:
    """The first n cards' name and power limit, as nvidia-smi gives them;
    None where nvidia-smi cannot be run."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    return res.stdout.strip().splitlines()[:n]


def digest(ids: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(ids, dtype=np.int32).tobytes()).hexdigest()


@contextlib.contextmanager
def counting_collectives():
    """Counts the torch.distributed collectives called inside the block,
    by function name, into the dict it yields."""
    issued: dict = {}
    originals = {name: getattr(dist, name) for name in COLLECTIVES}

    def counting(name, fn):
        def call(*args, **kwargs):
            issued[name] = issued.get(name, 0) + 1
            return fn(*args, **kwargs)
        return call

    for name in COLLECTIVES:
        setattr(dist, name, counting(name, originals[name]))
    try:
        yield issued
    finally:
        for name in COLLECTIVES:
            setattr(dist, name, originals[name])


class _Rank:
    """One rank's run: measures each path's encode, checks it and keeps
    its record; rank 0 prints each path's line."""

    def __init__(self, rank: int, cfg: dict, dev: torch.device):
        self.rank, self.cfg, self.dev = rank, cfg, dev
        self.world = cfg["world"]
        self.records: list[dict] = []

    def run(self, path: str, grid, encode, *, inner=None, launched=(), per_dispatch=None,
            per_encode=None, rows=False, **extra):
        """encode() -> (ids, total, want, total_want) on this rank, with
        every kernel's launch count set to 0 just before it, the
        collectives counted and, where `inner` (a WordEncoder) is given,
        its dispatches.  Fails unless the ids and total equal the oracle's,
        each kernel in `launched` ran once per dispatch (once per encode
        without `inner`) and no other did (on the CPU none does), and the
        collectives are `per_dispatch` a dispatch or `per_encode` in all.
        `rows`: the line also gives the rows this rank holds in the first
        dispatch, per width bucket (the port's layout: data_slices pads
        every bucket to a multiple of the data axis)."""
        dispatched: list = []
        if inner is not None:
            orig = inner._dispatch_buckets

            def counted(mats):
                if any(m.shape[0] for m in mats):
                    dispatched.append([m for m in mats if m.shape[0]])
                return orig(mats)

            inner._dispatch_buckets = counted
        for c in KERNELS.values():
            c.launches = 0
        try:
            with counting_collectives() as issued:
                t0 = time.perf_counter()
                ids, total, want, total_want = encode()
                seconds = time.perf_counter() - t0
        finally:
            if inner is not None:
                del inner._dispatch_buckets
        dispatches = len(dispatched) if inner is not None else 1
        launches = {k: c.launches for k, c in KERNELS.items()}
        ok = ids.dtype == np.int32 and np.array_equal(ids, want) and total == total_want
        n_issued = sum(issued.values())
        line = {
            "phase": "dryrun", "path": path, "world_size": self.world,
            "backend": dist.get_backend(), "grid": [grid.n_data, grid.n_vocab],
            "device": str(self.dev), "ids": int(ids.shape[0]), "total": int(total),
            "equal_oracle": bool(ok), "dispatches": dispatches, "collectives": dict(issued),
            "collectives_per_dispatch": n_issued / dispatches if dispatches else None,
            "collectives_per_encode": n_issued,
            "launches": launches,
            "verify_repairs": None if inner is None else inner.verify_repairs,
            "device_fallbacks": None if inner is None else inner.device_fallbacks,
            "seconds": seconds, **extra,
        }
        if rows and dispatched:
            line["first_dispatch"] = {
                f"w{m.shape[1]}": {"units": int(m.shape[0]), "rows_per_rank": int(sl.shape[0])}
                for m, sl in zip(dispatched[0], data_slices(dispatched[0], grid))
            }
        if self.dev.type == "cuda":
            line["cards"] = self.cfg["cards"]
        self.records.append({"path": path, "device": str(self.dev), "ids": int(ids.shape[0]),
                             "sha256": digest(ids), "total": int(total), "equal_oracle": bool(ok),
                             **extra})
        if self.rank == 0:
            print(json.dumps(line), flush=True)
            with open(os.path.join(self.cfg["dir"], "lines.jsonl"), "a") as f:
                f.write(json.dumps(line) + "\n")
        where = f"rank {self.rank}, {path}"
        if not ok:
            raise AssertionError(f"{where}: ids differ from the native oracle "
                                 f"({ids.shape[0]} ids, total {total}, oracle {total_want})")
        if inner is not None and (inner.verify_repairs or inner.device_fallbacks):
            raise AssertionError(f"{where}: {inner.verify_repairs} units repaired on the host, "
                                 f"{inner.device_fallbacks} fetches rescued")
        on_card = self.dev.type == "cuda"
        expected = {k: (dispatches if on_card and k in launched else 0) for k in KERNELS}
        if dispatches < 1 or launches != expected:
            raise AssertionError(f"{where}: launches {launches} in {dispatches} dispatches, "
                                 f"expected {expected}")
        want_issued = per_encode if per_dispatch is None else per_dispatch * dispatches
        if n_issued != want_issued:
            raise AssertionError(f"{where}: collectives {dict(issued)} in {dispatches} "
                                 f"dispatches, expected {want_issued}")


def _stream_phase(r: _Rank, vocab) -> None:
    """Phase 1: the stream engine on the demo text, 2-D where n >= 4 is
    even, else 1-D (__graft_entry__.py:119-163)."""
    n, dev = r.world, r.dev
    cps = uni.decode_utf8(DEMO_TEXT).astype(np.int32)
    if n >= 4 and n % 2 == 0:
        grid = make_mesh(n // 2, 2)
        sidx = build_index_sharded(vocab, 2)
        table, statics = mf.load_table(sidx.tables[grid.v], dev), index_statics(sidx)
        # The combine's two all_reduce, then the gather's three.
        fn, path, per_encode = encode_2d_parallel, "stream_2d", 5
    else:
        grid = make_mesh(n)
        index = build_index(vocab)
        table, statics = mf.pack_table(index, dev), index_statics(index)
        # The total's all_reduce, the counts' and the ids' all_gather.
        fn, path, per_encode = encode_data_parallel, "stream_1d", 3
    shards, lens = shard_codepoints(cps, grid.n_data)
    cp_pad = pad_shards(shards, statics["max_len"])
    want = np.asarray(encode_oracle(cps, vocab), dtype=np.int32)

    def encode():
        ids, counts, total = fn(cp_pad, lens, table, mesh=grid, **statics)
        return assemble_ids(ids.cpu().numpy(), counts.cpu().numpy()), int(total), want, want.shape[0]

    r.run(path, grid, encode, launched=STREAM_KERNELS, per_encode=per_encode)


def _word_phases(r: _Rank, vocab, mesh) -> None:
    """Phase 2: the word engine on the demo text, 1-D over `mesh`, and on a
    (n/2) x 2 grid where n >= 4 is even (__graft_entry__.py:180-200)."""
    n = r.world
    want = np.asarray(encode_oracle(uni.decode_utf8(DEMO_TEXT), vocab), dtype=np.int32)
    grids = [("word_1d", mesh, ("word_match_commit", "compact"), 1)]
    if n >= 4 and n % 2 == 0:
        grids.append(("word_2d", make_mesh(n // 2, 2), ("word_match", "word_commit", "compact"), 2))
    for path, grid, launched, per_dispatch in grids:
        enc = ShardedWordEncoder(vocab, mesh=grid, device=r.cfg["device"])

        def encode(enc=enc):
            ids = enc.encode_bytes(DEMO_TEXT)
            return ids, ids.shape[0], want, want.shape[0]

        r.run(path, grid, encode, inner=enc._inner, launched=launched, per_dispatch=per_dispatch)


def _at_scale_phases(r: _Rank, mesh) -> None:
    """Phases 3 and 4 (__graft_entry__.py:203-276): the 1-D
    ShardedWordEncoder on the whole at-scale corpus, then
    MultiHostWordEncoder on this rank's byte range of its file."""
    with open(r.cfg["corpus"], "rb") as f:
        corpus = f.read()
    with open(r.cfg["vocab"], encoding="utf-8") as f:
        vocab = parse_vocab(json.load(f))
    oracle = loader.VocabHandle(vocab)
    want = oracle.encode(uni.decode_utf8(corpus))
    device = r.cfg["device"]

    enc = ShardedWordEncoder(vocab, mesh=mesh, device=device)

    def encode():
        ids = enc.encode_bytes(corpus)
        return ids, ids.shape[0], want, want.shape[0]

    r.run("at_scale_1d", mesh, encode, inner=enc._inner, launched=("word_match_commit", "compact"),
          per_dispatch=1, rows=True, bytes=len(corpus), vocab_size=vocab.size)

    mh = MultiHostWordEncoder(vocab, mesh=mesh, device=device)
    start, end = file_shard_bounds(r.cfg["corpus"], mh.process_index, mh.process_count)
    want_local = oracle.encode(uni.decode_utf8(corpus[start:end]))

    def encode_mh():
        ids, total = mh.encode_file(r.cfg["corpus"])
        return ids, total, want_local, want.shape[0]

    r.run("multihost", mesh, encode_mh, inner=mh._inner,
          launched=("word_match_commit", "compact"), per_encode=1, byte_range=[start, end])


def _worker(rank: int, cfg: dict) -> None:
    """One rank: forms the group (initialize_distributed binds cuda:rank
    first), runs the four phases, writes its records."""
    device = cfg["device"]
    if device == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    initialize_distributed(cfg["init"], cfg["world"], rank, device=device)
    try:
        r = _Rank(rank, cfg, rank_device(device))
        vocab = _demo_vocab()
        _stream_phase(r, vocab)
        mesh = make_mesh(r.world)
        _word_phases(r, vocab, mesh)
        _at_scale_phases(r, mesh)
        with open(os.path.join(cfg["dir"], f"rank{rank}.json"), "w") as f:
            json.dump(r.records, f)
    finally:
        dist.destroy_process_group()


def _run_rank(rank: int, fn, cfg: dict) -> None:
    """A rank's process: LOCAL_RANK is its rank (one host: rank r binds
    cuda:r, whatever launched the parent), stderr goes to a file the parent
    reads, and a SIGTERM dumps every thread's stack there before it ends
    the process (the parent's deadline)."""
    import faulthandler

    os.environ["LOCAL_RANK"] = str(rank)
    err = open(os.path.join(cfg["dir"], f"rank{rank}.err"), "w")  # open for the process's life
    os.dup2(err.fileno(), 2)
    faulthandler.register(signal.SIGTERM, file=err, all_threads=True, chain=True)
    fn(rank, cfg)


def _tail(path: str, limit: int = 4000) -> str:
    try:
        with open(path, errors="replace") as f:
            return f.read()[-limit:]
    except OSError:
        return "(no stderr)"


def _stop(procs) -> None:
    """SIGTERM every rank still running (its stack goes to its stderr),
    then SIGKILL what outlives 5 s."""
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5.0)
        if p.is_alive():
            p.kill()
            p.join()


def dryrun_multichip(n_devices: int, *, device="cuda") -> dict:
    """Run the dry run on n_devices ranks, one process each (module
    docstring).  Returns {"lines": rank 0's phase lines, "ranks": each
    rank's records (path, device, ids, their sha256, total,
    equal_oracle)}.  device="cuda" takes one card per rank (nccl), raises
    before any process starts when there are fewer cards, and raises
    unless rank r ran on cuda:r; device="cpu" runs gloo."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    dev = resolve_device(device)
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise RuntimeError(f"{n_devices} ranks need {n_devices} cards (nccl takes one a rank); "
                           f"{torch.cuda.device_count()} visible")
    if not loader.available():
        raise RuntimeError("the dry run needs the native host runtime (runtime/native)")
    cards = None
    if dev.type == "cuda":
        # One build before the ranks start, not one nvcc per rank.
        with ThreadPoolExecutor(max_workers=4) as pool:
            for fut in [pool.submit(m.build) for m in (wk, mfc, tfc, cc)]:
                fut.result()
        cards = card_lines(n_devices)
    corpus = at_scale_corpus()
    lines = make_vocab(corpus, vocab_size=8000)
    with tempfile.TemporaryDirectory(prefix="wordpiece_dryrun_") as tmp:
        cfg = {"world": n_devices, "device": dev.type, "init": f"file://{tmp}/pg", "dir": tmp,
               "corpus": os.path.join(tmp, "corpus.txt"), "vocab": os.path.join(tmp, "vocab.json"),
               "cards": cards}
        with open(cfg["corpus"], "wb") as f:
            f.write(corpus)
        with open(cfg["vocab"], "w", encoding="utf-8") as f:
            json.dump(lines, f)

        def fail(what: str, shown) -> RuntimeError:
            return RuntimeError(f"dryrun_multichip({n_devices}, device={dev.type!r}): {what}\n"
                                + "\n".join(f"--- rank {rank} stderr:\n"
                                            + _tail(os.path.join(tmp, f"rank{rank}.err"))
                                            for rank in shown))

        # A rank that exits non-zero makes join() stop the others and raise.
        ctx = mp.start_processes(_run_rank, args=(_worker, cfg), nprocs=n_devices, join=False,
                                 start_method="spawn")
        end = time.monotonic() + DEADLINE_S
        try:
            while not ctx.join(timeout=max(end - time.monotonic(), 0.0)):
                if time.monotonic() >= end:
                    _stop(ctx.processes)
                    raise fail(f"the {n_devices} ranks outlived their {DEADLINE_S} s deadline",
                               range(n_devices))
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            rank = e.error_index
            raise fail(f"rank {rank} exited with code {ctx.processes[rank].exitcode}\n"
                       f"{str(e).strip()}",
                       [rank]) from None
        with open(os.path.join(tmp, "lines.jsonl")) as f:
            out_lines = [json.loads(ln) for ln in f]
        ranks = []
        for rank in range(n_devices):
            with open(os.path.join(tmp, f"rank{rank}.json")) as f:
                ranks.append(json.load(f))
    if dev.type == "cuda":
        for rank, recs in enumerate(ranks):
            on = {rec["device"] for rec in recs}
            if on != {f"cuda:{rank}"}:
                raise RuntimeError(f"rank {rank} ran on {sorted(on)}, not cuda:{rank}")
    return {"lines": out_lines, "ranks": ranks}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Multi-process dry run of wordpiece_tpu_torch")
    ap.add_argument("--devices", type=int, required=True, help="ranks, one process each")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: one card per rank, nccl (default); cpu: gloo")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    out = dryrun_multichip(args.devices, device=args.device)
    print(json.dumps({"dryrun_multichip": args.devices, "device": args.device, "ok": True,
                      "paths": [ln["path"] for ln in out["lines"]],
                      "rank_devices": [recs[0]["device"] for recs in out["ranks"]],
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's dry run (wordpiece_tpu_torch/dryrun.py) on gloo CPU process
groups of 2 and 4 real processes, against the JAX package: its sharded
stream and word encoders on the conftest's virtual CPU mesh for the demo
text, and its native oracle for the at-scale corpus and each rank's byte
range of it.

dryrun_multichip returns each rank's records; a record holds the sha256 of
the rank's int32 id stream, which is compared with the sha256 of the JAX
ids (the dry run itself holds every rank's ids against the port's oracle).
Both world sizes run at once, in two threads of the test process, while
it computes the JAX references; each run's file rendezvous lies in the
test's temporary directory, and a set of ranks that outlives its deadline
is killed and fails the test.  The at-scale corpus is the dry run's own
4.5 MB: the port encodes it on the CPU in about a second a rank.  The
port's corpus cache points at a temporary directory, so its own corpus
and vocabulary generators make what the dry run encodes.  Ids are
integers: exact."""

import ast
import glob
import hashlib
import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist

from wordpiece_tpu_torch import dryrun
from wordpiece_tpu_torch.bench import corpus as port_corpus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)  # __graft_entry__, the JAX dry run
WORLDS = (2, 4)
DEADLINE_S = 150.0

torch.set_num_threads(1)


def sha(ids) -> str:
    return hashlib.sha256(np.ascontiguousarray(ids, dtype=np.int32).tobytes()).hexdigest()


def record(ranks, rank: int, path: str) -> dict:
    (rec,) = [r for r in ranks[rank] if r["path"] == path]
    return rec


# ---- the JAX references -------------------------------------------------------
def jax_stream(n: int):
    """The JAX dry run's stream phase (__graft_entry__.py:115-163) on n
    virtual devices: (ids, total)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from __graft_entry__ import _demo_vocab
    from wordpiece_tpu.core import unicode as juni
    from wordpiece_tpu.core.vocab import build_index
    from wordpiece_tpu.ops.match_fast import pack_table
    from wordpiece_tpu.parallel import sharding as shd
    from wordpiece_tpu.parallel.vocab_parallel import build_index_sharded

    vocab = _demo_vocab()
    cps = juni.decode_utf8(dryrun.DEMO_TEXT).astype(np.int32)
    devices = np.asarray(jax.devices()[:n])
    if n >= 4 and n % 2 == 0:
        mesh = Mesh(devices.reshape(n // 2, 2), ("data", "vocab"))
        index = build_index_sharded(vocab, 2)
        table, fn, n_data = jnp.asarray(index.tables), shd.encode_2d_parallel, n // 2
    else:
        mesh = Mesh(devices, ("data",))
        index = build_index(vocab)
        table, fn, n_data = pack_table(index), shd.encode_data_parallel, n
    shards, lens = shd.shard_codepoints(cps, n_data)
    cp_pad = np.zeros((n_data, shards.shape[1] + index.max_len), dtype=np.int32)
    cp_pad[:, : shards.shape[1]] = shards
    ids, counts, total = fn(
        jnp.asarray(cp_pad), jnp.asarray(lens), table, mesh=mesh, max_len=int(index.max_len),
        max_probe=int(index.max_probe), log2_size=int(index.log2_size), mult1=int(index.mult1),
        mult2=int(index.mult2), unk_id=int(index.unk_token_id),
    )
    return shd.assemble_ids(np.asarray(ids), np.asarray(counts)), int(total)


def jax_word(shape: tuple) -> np.ndarray:
    """The JAX ShardedWordEncoder on the demo text over a mesh of `shape`:
    (n,) is 1-D, (n_data, 2) the (data, vocab) mesh."""
    import jax
    from jax.sharding import Mesh

    from __graft_entry__ import _demo_vocab
    from wordpiece_tpu.parallel.word_sharding import ShardedWordEncoder

    devices = np.asarray(jax.devices()[: int(np.prod(shape))]).reshape(shape)
    mesh = Mesh(devices, ("data",) if len(shape) == 1 else ("data", "vocab"))
    return ShardedWordEncoder(_demo_vocab(), mesh=mesh).encode_bytes(dryrun.DEMO_TEXT)


def jax_at_scale(tmp_dir) -> dict:
    """The JAX dry run's at-scale corpus (__graft_entry__.py:217-221), its
    oracle ids, and for each world size each rank's byte range
    (file_shard_bounds) with the oracle's ids of it."""
    from wordpiece_tpu.bench.corpus import make_corpus, make_vocab
    from wordpiece_tpu.core.vocab import parse_vocab
    from wordpiece_tpu.parallel.multihost import file_shard_bounds
    from wordpiece_tpu.runtime import loader

    corpus = make_corpus(4_500_000)
    corpus = corpus + b" " + b"q" * 5000 + b" " + corpus[:1000]
    lines = make_vocab(corpus, vocab_size=8000)
    handle = loader.VocabHandle(parse_vocab(lines))
    path = os.path.join(tmp_dir, "corpus.txt")
    with open(path, "wb") as f:
        f.write(corpus)
    out = {"corpus": corpus, "vocab": lines, "ids": handle.encode(loader.decode_utf8(corpus))}
    for n in WORLDS:
        bounds = [file_shard_bounds(path, rank, n) for rank in range(n)]
        out[n] = [(list(b), handle.encode(loader.decode_utf8(corpus[b[0] : b[1]]))) for b in bounds]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each world size's dry run (both at once, in threads) and the JAX
    references.  The port's corpus cache is a fresh directory (the
    packages' caches share one key): the port's generators make the
    at-scale corpus and vocabulary here, once, and both dry runs read them
    from that cache."""
    refs = {"at_scale": jax_at_scale(tmp_path_factory.mktemp("jax"))}
    saved = (tempfile.tempdir, dryrun.DEADLINE_S, port_corpus.CACHE_DIR)
    tempfile.tempdir, dryrun.DEADLINE_S = str(tmp_path_factory.mktemp("dryrun")), DEADLINE_S
    port_corpus.CACHE_DIR = str(tmp_path_factory.mktemp("port_cache"))
    try:
        corpus = dryrun.at_scale_corpus()
        refs["port_at_scale"] = (corpus, port_corpus.make_vocab(corpus, vocab_size=8000))
        with ThreadPoolExecutor(max_workers=len(WORLDS)) as pool:
            futures = {n: pool.submit(dryrun.dryrun_multichip, n, device="cpu") for n in WORLDS}
            refs["stream"] = {n: jax_stream(n) for n in WORLDS}
            refs["word_1d"] = {n: jax_word((n,)) for n in WORLDS}
            refs["word_2d"] = {4: jax_word((2, 2))}
            outs = {n: f.result() for n, f in futures.items()}
    finally:
        tempfile.tempdir, dryrun.DEADLINE_S, port_corpus.CACHE_DIR = saved
    return outs, refs


# ---- the dry run on 2 and 4 gloo processes -----------------------------------------
@pytest.mark.parametrize("world", WORLDS)
def test_stream_equal_jax(world, runs):
    """Stream engine: 1-D on 2 ranks, the 2 x 2 grid on 4; every rank's
    ids and total equal the JAX package's on the same grid."""
    outs, refs = runs
    ids, total = refs["stream"][world]
    path = "stream_2d" if world == 4 else "stream_1d"
    for rank in range(world):
        rec = record(outs[world]["ranks"], rank, path)
        assert (rec["ids"], rec["total"], rec["sha256"]) == (len(ids), total, sha(ids)), rank
        assert rec["equal_oracle"] and rec["device"] == "cpu"


@pytest.mark.parametrize("world,path", [(2, "word_1d"), (4, "word_1d"), (4, "word_2d")])
def test_word_equal_jax(world, path, runs):
    outs, refs = runs
    ids = refs[path][world]
    for rank in range(world):
        rec = record(outs[world]["ranks"], rank, path)
        assert (rec["ids"], rec["sha256"]) == (len(ids), sha(ids)), rank
        assert rec["equal_oracle"]


@pytest.mark.parametrize("world", WORLDS)
def test_at_scale_equal_jax_oracle(world, runs):
    outs, refs = runs
    ref = refs["at_scale"]
    assert refs["port_at_scale"] == (ref["corpus"], ref["vocab"])  # the port's own generators
    for rank in range(world):
        rec = record(outs[world]["ranks"], rank, "at_scale_1d")
        assert (rec["ids"], rec["sha256"]) == (len(ref["ids"]), sha(ref["ids"])), rank
        assert rec["bytes"] == len(ref["corpus"]) and rec["vocab_size"] == 8000


@pytest.mark.parametrize("world", WORLDS)
def test_multihost_equal_jax_oracle(world, runs):
    """Each rank encodes its own byte range of the corpus file (the JAX
    package's file_shard_bounds) equal to the JAX oracle's ids of it; the
    all-reduced total is the whole corpus's."""
    outs, refs = runs
    ref = refs["at_scale"]
    for rank, (bounds, ids) in enumerate(ref[world]):
        rec = record(outs[world]["ranks"], rank, "multihost")
        assert rec["byte_range"] == bounds, rank
        assert (rec["ids"], rec["sha256"]) == (len(ids), sha(ids)), rank
        assert rec["total"] == len(ref["ids"])
        assert rec["ids"] > 0


@pytest.mark.parametrize("world", WORLDS)
def test_phase_lines(world, runs):
    """Rank 0's lines: one a path, in order, on gloo, with the grid, one
    collective a 1-D word dispatch, two a 2-D one, one a multi-process
    encode, no kernel launched (the CPU runs the plain versions), no
    repaired unit and no rescued fetch."""
    outs, _ = runs
    lines = {ln["path"]: ln for ln in outs[world]["lines"]}
    order = (["stream_2d", "word_1d", "word_2d"] if world == 4 else ["stream_1d", "word_1d"]) + [
        "at_scale_1d", "multihost"]
    assert [ln["path"] for ln in outs[world]["lines"]] == order
    half = [world // 2, 2]
    for path, ln in lines.items():
        assert (ln["phase"], ln["world_size"], ln["backend"], ln["device"]) == (
            "dryrun", world, "gloo", "cpu")
        assert ln["grid"] == (half if path.endswith("2d") else [world, 1])
        assert ln["equal_oracle"] and ln["dispatches"] >= 1 and ln["seconds"] > 0
        assert set(ln["launches"].values()) == {0}
        assert set(ln["launches"]) == set(dryrun.KERNELS)
        assert "cards" not in ln
        if not path.startswith("stream"):
            assert ln["verify_repairs"] == 0 and ln["device_fallbacks"] == 0
    assert {"compute_features", "commit_with_positions", "match_positions"} == set(
        dryrun.STREAM_KERNELS)
    assert lines["word_1d"]["collectives_per_dispatch"] == 1
    assert lines["at_scale_1d"]["collectives_per_dispatch"] == 1
    assert lines["multihost"]["collectives"] == {"all_reduce": 1}
    if world == 4:
        assert lines["word_2d"]["collectives"] == {"all_reduce": 1, "all_gather": 1}
    rows = lines["at_scale_1d"]["first_dispatch"]
    assert rows and all(r["rows_per_rank"] == -(-r["units"] // world) for r in rows.values())


# ---- the entry step and the demo vocabulary ------------------------------------------
def test_demo_vocab_lines_equal_jax(monkeypatch):
    import wordpiece_tpu.core.vocab as jax_vocab
    from __graft_entry__ import _demo_vocab

    seen = []
    parse = jax_vocab.parse_vocab
    monkeypatch.setattr(jax_vocab, "parse_vocab", lambda lines: seen.append(lines) or parse(lines))
    _demo_vocab()
    assert seen == [dryrun._demo_lines()]


def test_entry_equal_jax():
    """entry(device="cpu") against the JAX entry() on the same units.  The
    JAX step takes the 512 x 15 unit matrix padded by max_len columns of
    spaces; the port's takes the unit matrix itself (columns past the
    width read as space).  Both emit int32[512, 15]."""
    from __graft_entry__ import entry as jax_entry

    fn, (units, tables) = dryrun.entry(device="cpu")
    jfn, jargs = jax_entry()
    want = np.asarray(jfn(*jargs))
    jmat = np.asarray(jargs[0])
    np.testing.assert_array_equal(units.numpy(), jmat[:, :15])
    assert (jmat[:, 15:] == 32).all()
    got = fn(units, tables)
    assert got.dtype == torch.int32 and got.shape == (512, 15)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != -2).sum() >= 512  # every unit emits


# ---- what the parent refuses and how it fails ------------------------------------------
def test_more_ranks_than_cards_raises_before_any_process(monkeypatch):
    """device="cuda" with more ranks than cards raises before a process
    starts (nccl takes one card a rank), also where a card is present."""
    import multiprocessing

    def no_process(*a, **k):
        raise AssertionError("a process was started")

    monkeypatch.setattr(multiprocessing, "get_context", no_process)
    with pytest.raises(RuntimeError):
        dryrun.dryrun_multichip(2, device="cuda")  # no card here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 ranks need 2 cards"):
        dryrun.dryrun_multichip(2, device="cuda")
    with pytest.raises(ValueError):
        dryrun.dryrun_multichip(0, device="cpu")


def _raising_worker(rank: int, cfg: dict) -> None:
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    time.sleep(600)  # rank 0 would wait for rank 1 in a collective


def _hanging_worker(rank: int, cfg: dict) -> None:
    print(f"rank {rank} ready", file=sys.stderr, flush=True)  # its SIGTERM stack dump is set
    time.sleep(600)


@pytest.mark.parametrize("case", ["raises", "hangs"])
def test_failing_rank_fails_the_run(case, monkeypatch):
    """A rank that raises makes dryrun_multichip raise at once with that
    rank's stderr; ranks that outlive the deadline are killed, and the
    error holds the stack of every rank that had reached its worker (a
    rank still starting up on a loaded host when the deadline falls has
    none to give).  No process is left behind."""
    import multiprocessing

    # The deadline covers each rank's start-up (spawn, import torch): 12 s
    # leaves a loaded host the time to reach the worker.
    worker, deadline = {"raises": (_raising_worker, 60.0), "hangs": (_hanging_worker, 12.0)}[case]
    monkeypatch.setattr(dryrun, "_worker", worker)
    monkeypatch.setattr(dryrun, "DEADLINE_S", deadline)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        dryrun.dryrun_multichip(2, device="cpu")
    took = time.monotonic() - t0
    if case == "raises":
        assert "rank 1 exited with code 1" in str(err.value)
        assert "rank 1 fails on purpose" in str(err.value)
        assert took < 45
    else:
        assert "outlived their 12.0 s deadline" in str(err.value)
        reached = str(err.value).count(" ready\n")
        assert str(err.value).count("_hanging_worker") == reached  # each such rank's stack
        assert took < 45
    assert not multiprocessing.active_children()


def _card_worker(rank: int, cfg: dict) -> None:
    """Records the rank's LOCAL_RANK and the card it would bind."""
    from wordpiece_tpu_torch.parallel.sharding import rank_card

    open(os.path.join(cfg["dir"], "lines.jsonl"), "a").close()
    with open(os.path.join(cfg["dir"], f"rank{rank}.json"), "w") as f:
        json.dump([{"local_rank": os.environ["LOCAL_RANK"], "card": rank_card(rank)}], f)


def test_each_rank_binds_its_own_card_under_a_launcher(monkeypatch):
    """A parent started by a launcher that sets LOCAL_RANK (torchrun)
    passes it on to the ranks it spawns; each rank still binds card r
    (rank_card, which initialize_distributed and rank_device use)."""
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setattr(dryrun, "_worker", _card_worker)
    out = dryrun.dryrun_multichip(2, device="cpu")
    assert out["ranks"] == [[{"local_rank": str(r), "card": r}] for r in range(2)]


# ---- the card binding --------------------------------------------------------------
CUDA_WRAPPERS = sorted(glob.glob(os.path.join(ROOT, "wordpiece_tpu_torch", "ops", "*_cuda.py")))


def _selects_card(node) -> bool:
    return (isinstance(node, ast.With) and any(
        isinstance(i.context_expr, ast.Call) and ast.unparse(i.context_expr.func) == "torch.cuda.device"
        for i in node.items))


@pytest.mark.parametrize("path", CUDA_WRAPPERS, ids=os.path.basename)
def test_every_launch_selects_its_card(path):
    """Every lib.wp_* call (a kernel launch through ctypes: the C side
    launches on the current device) lies inside a `with
    torch.cuda.device(...)` block."""
    tree = ast.parse(open(path, encoding="utf-8").read())
    launches, outside = [], []

    def visit(node, inside: bool) -> None:
        inside = inside or _selects_card(node)
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr.startswith("wp_") and ast.unparse(node.func.value) == "lib"):
            launches.append(node.lineno)
            if not inside:
                outside.append(node.lineno)
        for child in ast.iter_child_nodes(node):
            visit(child, inside)

    visit(tree, False)
    assert launches, f"no launch found in {path}"
    assert not outside, f"launches outside torch.cuda.device(...) at lines {outside}"


@pytest.mark.parametrize("case", ["local_rank", "rank_mod_cards", "cpu"])
def test_initialize_distributed_binds_the_card_first(case, monkeypatch):
    """For nccl the rank's card is bound (torch.cuda.set_device, then the
    group's device_id) before the group forms: LOCAL_RANK where the
    launcher sets it, else rank % device_count; gloo binds none."""
    from wordpiece_tpu_torch.parallel.multihost import initialize_distributed

    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.append(("set_device", d)))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", lambda backend, **kw: calls.append(
        ("init", backend, kw.get("device_id"), kw["rank"], kw["world_size"], kw["init_method"])))
    if case == "local_rank":
        monkeypatch.setenv("LOCAL_RANK", "2")
    else:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    initialize_distributed("localhost:29500", 8, 5, device="cpu" if case == "cpu" else "cuda")
    init = "tcp://localhost:29500"
    if case == "cpu":
        assert calls == [("init", "gloo", None, 5, 8, init)]
    else:
        card = torch.device("cuda", 2 if case == "local_rank" else 5 % 4)
        assert calls == [("set_device", card), ("init", "nccl", card, 5, 8, init)]

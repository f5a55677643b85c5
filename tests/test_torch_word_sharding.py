"""The port's word-engine sharding (parallel/word_sharding.py,
parallel/multihost.py) on gloo CPU process groups, against the JAX
package's ShardedWordEncoder and MultiHostWordEncoder on the conftest's
virtual CPU mesh and against the native oracle.

The ranks are real processes: this file, run as a script, is the worker
(`python tests/test_torch_word_sharding.py CONFIG`), and it imports torch
and the port only (jax is imported inside the test functions, which the
workers never run).  Groups rendezvous through a file in the test's
temporary directory; a worker set that outlives its deadline is killed and
fails the test.  Both world sizes run at once, while the parent computes
the JAX references.  Ids are integers: exact."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)  # chip_smoke's helpers, and the port in the workers
DEADLINE_S = 150
WORLDS = (2, 4)

torch.set_num_threads(1)


def sharded_case(short: bool = False):
    """(text, vocab lines) from a fixed seed (tests/test_sharding.py:
    87-110, widened): short words, one word for every width bucket
    (7/15/31/127), a 300-codepoint overflow unit, CJK, punctuation and an
    astral token.  `short` drops the long words and the overflow unit (two
    buckets: the JAX package's 1-D reference compiles its interpret-mode
    kernel per bucket, ~10 s each)."""
    rng = np.random.default_rng(11)
    words = ["".join(rng.choice(list("abcdefgh"), size=int(rng.integers(1, 12)))) for _ in range(90)]
    longs = ["".join(rng.choice(list("abcdefgh"), size=n)) for n in (13, 20, 29, 40, 64, 100, 120)]
    text = " ".join(rng.choice(words) for _ in range(700))
    if not short:
        text += " " + " ".join(longs) + " " + "q" * 300
    text += " 中文 mix-ed punct, 𠀀x 𠀀"
    lines = sorted(
        {w[:3] for w in words} | {"##" + w[3:] for w in words if len(w) > 3}
        | {"##" + c for c in "abcdefghq"} | set("abcdefghq")
        | {"中", "文", "mix", "##ed", "-", ",", "𠀀", "##x", "[UNK]"}
    )
    return text, lines


MULTIHOST_LINES = (
    ["[PAD]", "[UNK]", "the", "quick", "brown", "fox", "jump", "##s", "##ed",
     "over", "lazy", "dog", "-", ",", ".", "qu", "##ick", "an", "and", "a"]
    + [c for c in "abcdefghijklmnopqrstuvwxyz"]
    + ["##" + c for c in "abcdefghijklmnopqrstuvwxyz"]
)


def multihost_corpus() -> bytes:
    """tests/test_multihost.py's two corpora in one file: the repeated
    sentence, then words of 1-120 letters (every bucket, uneven shards)
    and a 300-codepoint overflow unit."""
    rng = np.random.default_rng(7)
    words = ["".join(rng.choice(list("abcdefg"), size=int(rng.choice([1, 3, 7, 15, 40, 120]))))
             for _ in range(500)]
    return ("the quick brown fox jumps over the lazy dog and a zebra-dog, " * 100
            + " ".join(words) + " " + "q" * 300).encode()


def unit_buckets(vocab, data: bytes) -> list:
    """The non-empty width buckets of `data`'s unique units, narrowed."""
    from wordpiece_tpu_torch.engine_word import WIDTHS, _narrow
    from wordpiece_tpu_torch.runtime import loader

    _, us, ul, ucp = loader.segment_dedupe(data)
    mats, _, _ = loader.bucket_fill(data, us, ul, ucp, list(WIDTHS))
    return [_narrow(m) for m in mats if m.shape[0]]


def small_chunks(enc) -> None:
    """Many pipeline chunks, and a device dispatch for every chunk with a
    new unit: the collectives then run on the pipeline's worker thread,
    chunk after chunk."""
    enc.PIPELINE_FIRST = 2000
    enc.PIPELINE_CHUNK = 3000
    enc.SCALAR_MAX_NEW = 0


# ---- the worker: one rank of a gloo group ----------------------------------
def worker(cfg: dict) -> None:
    from datetime import timedelta

    import torch.distributed as dist

    rank, world = cfg["rank"], cfg["world"]
    dist.init_process_group("gloo", init_method=cfg["init"], rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    from wordpiece_tpu_torch.core.length_tables import load_length_tables
    from wordpiece_tpu_torch.core.vocab import parse_vocab
    from wordpiece_tpu_torch.parallel import multihost as mh
    from wordpiece_tpu_torch.parallel import word_sharding as ws
    from wordpiece_tpu_torch.parallel.sharding import make_mesh

    text, lines = sharded_case()
    vocab, data = parse_vocab(lines), text.encode()
    mats = unit_buckets(vocab, data)
    out = {}

    def step(tag, fn, mesh, tables):
        cps = [torch.from_numpy(s) for s in ws.data_slices(mats, mesh)]
        emits, counts = fn(cps, tables, mesh=mesh)
        for b, (e, c) in enumerate(zip(emits, counts)):
            out[f"{tag}_emits_{b}"] = e.numpy()
            out[f"{tag}_counts_{b}"] = c.numpy()

    mesh = make_mesh()
    enc = ws.ShardedWordEncoder(vocab, mesh=mesh, device="cpu")
    small_chunks(enc._inner)
    out["ids_1d"] = enc.encode_bytes(data)
    out["ids_1d_short"] = enc.encode_bytes(sharded_case(short=True)[0].encode())
    step("step_1d", ws.word_encode_data_parallel, mesh, enc._inner.dtables)
    out["axes_1d"] = np.array(mesh.axis_names)
    column = make_mesh(world, 1)  # a vocab axis of length 1: the 2-D path, one partition
    enc = ws.ShardedWordEncoder(vocab, mesh=column, device="cpu")
    small_chunks(enc._inner)
    out["axes_column"] = np.array(column.axis_names)
    out["column_2d"] = np.array(enc._encode is ws.word_encode_2d_parallel)
    out["ids_column_short"] = enc.encode_bytes(sharded_case(short=True)[0].encode())
    if world == 4:
        grid = make_mesh(2, 2)
        out["coords_2d"] = np.array([grid.d, grid.v])
        enc = ws.ShardedWordEncoder(vocab, mesh=grid, device="cpu")
        small_chunks(enc._inner)
        out["ids_2d"] = enc.encode_bytes(data)
        part = load_length_tables(ws.partition_tables(enc._inner.tables, 2, grid.v), "cpu")
        step("step_2d", ws.word_encode_2d_parallel, grid, part)

    mvocab = parse_vocab(MULTIHOST_LINES)
    menc = mh.MultiHostWordEncoder(mvocab, device="cpu")
    small_chunks(menc._inner)
    out["mh_ids"], total = menc.encode_file(cfg["corpus"])
    out["mh_total"] = np.array([total, menc.last_global_total])
    out["mh_index"] = np.array([menc.process_index, menc.process_count])

    errors = []
    for make in (lambda: ws.ShardedWordEncoder(vocab, mesh=mesh, device="cuda"),
                 lambda: mh.MultiHostWordEncoder(mvocab, device="cuda")):
        try:
            make()
            errors.append("")
        except RuntimeError as e:
            errors.append(str(e))
    out["cuda_errors"] = np.array(errors)
    loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "wordpiece_tpu.")))
    assert not loaded, f"a worker imported {loaded[:3]}"
    np.savez(os.path.join(cfg["out"], f"rank{rank}.npz"), **out)
    # No rank leaves while another still connects the subgroups that the
    # CUDA encoders' grids made above (a peer's exit fails that connect).
    dist.barrier()
    dist.destroy_process_group()


def start(world: int, tmp_dir, corpus: str) -> list:
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = []
    for rank in range(world):
        cfg = {"rank": rank, "world": world, "init": f"file://{tmp_dir}/pg", "out": str(tmp_dir),
               "corpus": corpus}
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), json.dumps(cfg)],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        ))
    return procs


def finish(procs: list, world: int, tmp_dir, end: float) -> list[dict]:
    """Waits for a worker set until `end`; returns each rank's outputs."""
    errors = []
    try:
        for rank, p in enumerate(procs):
            _, err = p.communicate(timeout=max(1.0, end - time.monotonic()))
            if p.returncode != 0:
                errors.append(f"rank {rank} rc {p.returncode}:\n{err.decode()[-3000:]}")
    except subprocess.TimeoutExpired:
        errors.append(f"the {world} workers missed their {DEADLINE_S} s deadline")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if errors:
        pytest.fail("\n".join(errors))
    return [dict(np.load(os.path.join(tmp_dir, f"rank{r}.npz"))) for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each rank's outputs of a 2-rank and a 4-rank run (started together)
    and the JAX package's references, computed while the workers run."""
    corpus = tmp_path_factory.mktemp("corpus") / "corpus.txt"
    corpus.write_bytes(multihost_corpus())
    dirs = {w: tmp_path_factory.mktemp(f"world{w}") for w in WORLDS}
    procs = {w: start(w, dirs[w], str(corpus)) for w in WORLDS}
    end = time.monotonic() + DEADLINE_S
    try:
        refs = jax_references()
    finally:
        outs = {w: finish(procs[w], w, dirs[w], end) for w in WORLDS}
    return outs, refs


def jax_references() -> dict:
    """The JAX package's ShardedWordEncoder (1-D on 2 devices on the short
    sharded case, 2-D on a (4, 2) mesh on the whole one) and
    MultiHostWordEncoder on the multi-process corpus."""
    import jax
    from jax.sharding import Mesh

    from wordpiece_tpu.core.vocab import parse_vocab as jax_parse_vocab
    from wordpiece_tpu.parallel.multihost import MultiHostWordEncoder
    from wordpiece_tpu.parallel.word_sharding import ShardedWordEncoder

    text, lines = sharded_case()
    jvocab = jax_parse_vocab(lines)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    refs = {"1d": ShardedWordEncoder(jvocab, mesh=mesh).encode_bytes(
        sharded_case(short=True)[0].encode())}
    mesh = Mesh(np.asarray(jax.devices()).reshape(4, 2), ("data", "vocab"))
    refs["2d"] = ShardedWordEncoder(jvocab, mesh=mesh).encode_bytes(text.encode())
    refs["mh"], refs["mh_total"] = MultiHostWordEncoder(
        jax_parse_vocab(MULTIHOST_LINES)).encode_local_bytes(multihost_corpus())
    return refs


def oracle(lines, data: bytes) -> np.ndarray:
    from wordpiece_tpu_torch.core.vocab import parse_vocab
    from wordpiece_tpu_torch.runtime import loader

    return loader.VocabHandle(parse_vocab(lines)).encode(loader.decode_utf8(data))


def sharded_oracle(short: bool = False) -> np.ndarray:
    text, lines = sharded_case(short)
    return oracle(lines, text.encode())


# ---- the process groups ------------------------------------------------------
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_word_encoder_1d_equal_jax(world, runs):
    outs, refs = runs
    want, want_short = sharded_oracle(), sharded_oracle(short=True)
    np.testing.assert_array_equal(refs["1d"], want_short)
    for rank, out in enumerate(outs[world]):
        np.testing.assert_array_equal(out["ids_1d"], want, err_msg=f"rank {rank}")
        np.testing.assert_array_equal(out["ids_1d_short"], refs["1d"], err_msg=f"rank {rank}")
        assert out["ids_1d"].dtype == np.int32


@pytest.mark.parametrize("world", WORLDS)
def test_vocab_axis_of_one_runs_2d(world, runs):
    """The grid, not an option of the encoder, picks the path: make_mesh()
    is 1-D, make_mesh(world, 1) has a vocab axis (the JAX ("data",
    "vocab") mesh) and runs the 2-D path with one partition."""
    outs, refs = runs
    for rank, out in enumerate(outs[world]):
        assert out["axes_1d"].tolist() == ["data"]
        assert out["axes_column"].tolist() == ["data", "vocab"]
        assert bool(out["column_2d"]), f"rank {rank}"
        np.testing.assert_array_equal(out["ids_column_short"], refs["1d"], err_msg=f"rank {rank}")


def test_sharded_word_encoder_2d_equal_jax(runs):
    outs, refs = runs
    want = sharded_oracle()
    np.testing.assert_array_equal(refs["2d"], want)
    for rank, out in enumerate(outs[4]):
        assert out["coords_2d"].tolist() == [rank // 2, rank % 2]
        np.testing.assert_array_equal(out["ids_2d"], want, err_msg=f"rank {rank}")


def _plain_emits():
    from wordpiece_tpu_torch.core.vocab import parse_vocab
    from wordpiece_tpu_torch.engine_word import WordEncoder

    text, lines = sharded_case()
    vocab = parse_vocab(lines)
    tables = WordEncoder(vocab, device="cpu").dtables
    from wordpiece_tpu_torch.ops.word_kernel_cuda import word_match_commit_multi

    return word_match_commit_multi(
        [torch.from_numpy(m) for m in unit_buckets(vocab, text.encode())], tables)


@pytest.mark.parametrize("tag,world", [("step_1d", 2), ("step_1d", 4), ("step_2d", 4)])
def test_sharded_step_gathers_every_slice(tag, world, runs):
    """word_encode_data_parallel / word_encode_2d_parallel alone: every
    rank gets every slice of every bucket back in unit order (pad rows
    all-space, emitting nothing), and counts that match the emits and sum
    to the dispatch's total."""
    outs, _ = runs
    wants = [e.numpy() for e in _plain_emits()]
    total = sum(int((w != -2).sum()) for w in wants)
    for rank, out in enumerate(outs[world]):
        got = sum(int(out[f"{tag}_counts_{b}"].sum()) for b in range(len(wants)))
        assert got == total, f"rank {rank}"
        for b, want in enumerate(wants):
            emits, counts = out[f"{tag}_emits_{b}"], out[f"{tag}_counts_{b}"]
            u = want.shape[0]
            assert emits.shape[0] == -(-u // (world if tag == "step_1d" else 2)) * (
                world if tag == "step_1d" else 2)
            np.testing.assert_array_equal(emits[:u], want, err_msg=f"rank {rank} bucket {b}")
            assert (emits[u:] == -2).all()
            np.testing.assert_array_equal(counts, (emits != -2).sum(axis=1))


@pytest.mark.parametrize("world", WORLDS)
def test_multihost_shards_concat_equal_jax(world, runs):
    """Each rank encodes its own file_shard_bounds shard (its own number
    of chunks and dispatches); the streams concatenated in rank order equal
    the JAX package's MultiHostWordEncoder on the whole corpus, and every
    rank holds the global total."""
    outs, refs = runs
    want = oracle(MULTIHOST_LINES, multihost_corpus())
    np.testing.assert_array_equal(refs["mh"], want)
    assert refs["mh_total"] == want.shape[0]
    got = np.concatenate([out["mh_ids"] for out in outs[world]])
    np.testing.assert_array_equal(got, want)
    for rank, out in enumerate(outs[world]):
        assert out["mh_total"].tolist() == [want.shape[0]] * 2
        assert out["mh_index"].tolist() == [rank, world]
        assert out["mh_ids"].shape[0] > 0


@pytest.mark.parametrize("world", WORLDS)
def test_cuda_encoder_on_gloo_raises(world, runs):
    outs, _ = runs
    for out in outs[world]:
        for err in out["cuda_errors"].tolist():
            assert "cuda" in err.lower() or "nccl" in err


# ---- host-side functions and the plain split path: in process ---------------------
def _bert_tables():
    from wordpiece_tpu.core.length_tables import build_length_tables as jax_build
    from wordpiece_tpu.core.vocab import parse_vocab as jax_parse_vocab
    from wordpiece_tpu_torch.bench.corpus import make_corpus, make_vocab_bert
    from wordpiece_tpu_torch.core.length_tables import build_length_tables
    from wordpiece_tpu_torch.core.vocab import parse_vocab

    data = make_corpus(200_000)
    lines = make_vocab_bert(data)
    words = data.decode("utf-8", errors="ignore").split()
    return build_length_tables(parse_vocab(lines)), jax_build(jax_parse_vocab(lines)), words


TINY_LINES = ["[UNK]", "a", "ab", "abc", "##a", "##ab", "b", "##b", "cd", "##cd", "x"]


@pytest.mark.parametrize("n_vocab", [2, 3, 4])
def test_shard_word_tables_equal_jax(n_vocab):
    from wordpiece_tpu.core.length_tables import build_length_tables as jax_build
    from wordpiece_tpu.core.vocab import parse_vocab as jax_parse_vocab
    from wordpiece_tpu.parallel.word_sharding import shard_word_tables as jax_shard
    from wordpiece_tpu_torch.core.length_tables import build_length_tables
    from wordpiece_tpu_torch.core.vocab import parse_vocab
    from wordpiece_tpu_torch.parallel.word_sharding import partition_tables, shard_word_tables

    _, lines = sharded_case()
    for vocab_lines in (lines, TINY_LINES, ["[UNK]"]):
        mine = shard_word_tables(build_length_tables(parse_vocab(vocab_lines)), n_vocab)
        theirs = jax_shard(jax_build(jax_parse_vocab(vocab_lines)), n_vocab)
        for a, b in zip(mine[:3], theirs[:3]):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        assert mine[3] == theirs[3]
        host = build_length_tables(parse_vocab(vocab_lines))
        parts = [partition_tables(host, n_vocab, v) for v in range(n_vocab)]
        # Every active slot in exactly one partition, each with the whole
        # table's statics.
        ids = np.concatenate([p.tid[p.tid >= 0] for p in parts])
        assert sorted(ids.tolist()) == sorted(host.tid[host.tid >= 0].tolist())
        for p in parts:
            assert (p.max_len, p.mult1, p.lane_salts) == (host.max_len, host.mult1, host.lane_salts)
    with pytest.raises(ValueError):
        partition_tables(host, n_vocab, n_vocab)


def _jax_fns():
    import jax

    from wordpiece_tpu.ops.word_kernel import word_commit, word_match

    statics = ("width", "max_len", "rows_off", "mult1", "mult2", "lane_salts")
    return (jax.jit(word_match, static_argnames=statics),
            jax.jit(word_commit, static_argnames=("width", "max_len", "unk_id")))


@pytest.mark.parametrize("n_vocab", [2, 3])
def test_partition_matches_combine_to_whole(n_vocab):
    """The split path's plain versions (what the wrappers run on the CPU):
    word_match_multi on each partition equals the JAX word_match on the
    same partition; the max-combined partitions equal the whole table's
    matches; word_commit_multi on them equals the JAX word_commit and the
    plain fused result, emits and counts."""
    import jax.numpy as jnp

    from chip_smoke import max_combine, unit_matrices
    from wordpiece_tpu.parallel.word_sharding import shard_word_tables as jax_shard
    from wordpiece_tpu_torch.core.length_tables import load_length_tables
    from wordpiece_tpu_torch.engine_word import _narrow
    from wordpiece_tpu_torch.ops import word_kernel_cuda as wk
    from wordpiece_tpu_torch.parallel.word_sharding import partition_tables

    host, jhost, words = _bert_tables()
    jmatch, jcommit = _jax_fns()
    k1p, k2p, tidp, rows_off = jax_shard(jhost, n_vocab)
    r = k1p.shape[0] // n_vocab
    whole = load_length_tables(host, "cpu")
    parts = [load_length_tables(partition_tables(host, n_vocab, v), "cpu") for v in range(n_vocab)]
    rng = np.random.default_rng(5)
    for width in ((31,) if n_vocab == 2 else (127,)):
        mat = np.concatenate(list(unit_matrices(width, words, rng, n=12).values()))
        cp = torch.from_numpy(_narrow(mat))
        pad = np.full((mat.shape[0], width + host.max_len), 32, np.int32)
        pad[:, :width] = mat
        kw = dict(width=width, max_len=host.max_len, mult1=host.mult1, mult2=host.mult2,
                  lane_salts=tuple(host.lane_salts))
        per = []
        for v, tabs in enumerate(parts):
            (bid, blen), = wk.word_match_multi([cp], tabs)
            rows = slice(v * r, (v + 1) * r)
            jid, jlen = jmatch(jnp.asarray(pad), jnp.asarray(k1p[rows]), jnp.asarray(k2p[rows]),
                               jnp.asarray(tidp[rows]), rows_off=rows_off, **kw)
            np.testing.assert_array_equal(bid.numpy(), np.asarray(jid))
            np.testing.assert_array_equal(blen.numpy(), np.asarray(jlen))
            assert bid.dtype == blen.dtype == torch.int32
            per.append((bid, blen))
        combined = max_combine(per)
        (wid, wlen), = wk.word_match_multi([cp], whole)
        assert torch.equal(combined[0], wid) and torch.equal(combined[1], wlen)
        counts = torch.empty(mat.shape[0], dtype=torch.int32)
        emit, = wk.word_commit_multi([cp], [combined], max_len=host.max_len,
                                     unk_id=host.unk_token_id, counts=counts)
        want = jcommit(jnp.asarray(pad), jnp.asarray(combined[0].numpy()),
                       jnp.asarray(combined[1].numpy()), width=width, max_len=host.max_len,
                       unk_id=host.unk_token_id)
        np.testing.assert_array_equal(emit.numpy(), np.asarray(want))
        fused, = wk.word_match_commit_multi([cp], whole)
        assert torch.equal(emit, fused)
        np.testing.assert_array_equal(counts.numpy(), (emit != -2).sum(dim=1).numpy())


def test_split_wrappers_check_their_inputs():
    from wordpiece_tpu_torch.core.length_tables import build_length_tables, load_length_tables
    from wordpiece_tpu_torch.core.vocab import parse_vocab
    from wordpiece_tpu_torch.ops import word_kernel_cuda as wk

    tabs = load_length_tables(build_length_tables(parse_vocab(TINY_LINES)), "cpu")
    cp = torch.full((3, 7), 32, dtype=torch.uint8)
    (bid, blen), = wk.word_match_multi([cp], tabs)
    with pytest.raises(ValueError):
        wk.word_commit_multi([cp], [(bid[:2], blen[:2])], max_len=tabs.max_len, unk_id=0)
    with pytest.raises(ValueError):
        wk.word_commit_multi([cp, cp], [(bid, blen)], max_len=tabs.max_len, unk_id=0)
    emit, = wk.word_commit_multi([cp], [(bid, blen)], max_len=tabs.max_len, unk_id=0)
    assert (emit == -2).all()  # all-space rows emit nothing
    assert (wk.word_match_packed.launches, wk.word_commit_packed.launches) == (0, 0)


@pytest.mark.parametrize("n_procs", [1, 2, 3, 5, 8])
def test_file_shard_bounds_equal_jax(n_procs, tmp_path):
    from wordpiece_tpu.parallel.multihost import file_shard_bounds as jax_bounds
    from wordpiece_tpu_torch.parallel.multihost import file_shard_bounds

    for name, data in (("sentences", multihost_corpus()), ("spaceless", b"abc" + b"x" * 10_000)):
        p = tmp_path / f"{name}.txt"
        p.write_bytes(data)
        bounds = [file_shard_bounds(str(p), i, n_procs) for i in range(n_procs)]
        assert bounds == [jax_bounds(str(p), i, n_procs) for i in range(n_procs)]
        assert bounds[0][0] == 0 and bounds[-1][1] == len(data)
        for (_, e0), (s1, _) in zip(bounds, bounds[1:]):
            assert e0 == s1
        if name == "spaceless":  # later shards collapse to empty
            assert bounds[0] == (0, len(data))


def test_multihost_without_a_group_is_one_process():
    """No process group: initialize_distributed is a no-op for one process,
    and MultiHostWordEncoder runs as rank 0 of 1 with no collective."""
    import torch.distributed as dist

    from wordpiece_tpu_torch.core.vocab import parse_vocab
    from wordpiece_tpu_torch.parallel.multihost import (
        MultiHostWordEncoder, initialize_distributed,
    )

    initialize_distributed()
    initialize_distributed(num_processes=1)
    assert not dist.is_initialized()
    enc = MultiHostWordEncoder(parse_vocab(MULTIHOST_LINES), device="cpu")
    data = multihost_corpus()
    ids, total = enc.encode_local_bytes(data)
    want = oracle(MULTIHOST_LINES, data)
    np.testing.assert_array_equal(ids, want)
    assert total == enc.last_global_total == want.shape[0]
    assert (enc.process_index, enc.process_count) == (0, 1)


if __name__ == "__main__":
    worker(json.loads(sys.argv[1]))

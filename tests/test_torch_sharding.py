"""The port's stream-engine sharding (parallel/sharding.py,
parallel/vocab_parallel.py) on gloo CPU process groups, against the JAX
package's on the conftest's virtual CPU mesh and the oracle.

The ranks are real processes: this file, run as a script, is the worker
(`python tests/test_torch_sharding.py CONFIG`), and it imports torch and
the port only (jax is imported inside the test functions, which the
workers never run).  Groups rendezvous through a file in the test's
temporary directory; a worker set that outlives its deadline is killed and
fails the test.  Ids are integers: exact."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 150


def corpus_case():
    """(text, vocab lines) from a fixed seed: words, CJK, punctuation and
    an astral token, with long and short words."""
    rng = np.random.default_rng(11)
    words = ["".join(rng.choice(list("abcdefgh"), size=int(rng.integers(1, 12)))) for _ in range(90)]
    text = " ".join(rng.choice(words) for _ in range(700)) + " 中文 mix-ed punct, 𠀀x 𠀀"
    lines = sorted(
        {w[:3] for w in words} | {"##" + w[3:] for w in words if len(w) > 3}
        | {"##" + c for c in "abcdefgh"} | set("abcdefgh")
        | {"中", "文", "mix", "##ed", "-", ",", "𠀀", "##x", "[UNK]"}
    )
    return text, lines


def chain_case() -> str:
    """Short units, then one unit of 600 `a`: the rank that holds it walks
    a chain of hundreds of steps, a rank of short units chains of one."""
    return "a " * 600 + "a" * 600


def partial_matches(rank: int, n: int = 257):
    """A rank's made-up partition matches for the combine check."""
    rng = np.random.default_rng(100 + rank)
    best_len = rng.integers(0, 4, size=n).astype(np.int32)
    best_id = np.where(best_len > 0, rng.integers(0, 50, size=n), -1).astype(np.int32)
    return best_id, best_len


# ---- the worker: one rank of a gloo group ----------------------------------
def worker(cfg: dict) -> None:
    from datetime import timedelta

    import torch.distributed as dist

    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    rank, world = cfg["rank"], cfg["world"]
    dist.init_process_group("gloo", init_method=cfg["init"], rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    from wordpiece_tpu_torch.core import unicode as uni
    from wordpiece_tpu_torch.core.vocab import parse_vocab
    from wordpiece_tpu_torch.engine import index_statics
    from wordpiece_tpu_torch.ops import commit
    from wordpiece_tpu_torch.ops.match_fast import load_table
    from wordpiece_tpu_torch.parallel import sharding as sh
    from wordpiece_tpu_torch.parallel import vocab_parallel as vp

    text, lines = corpus_case()
    vocab = parse_vocab(lines)
    cps = uni.decode_utf8(text.encode()).astype(np.int32)
    out = {}

    mesh = sh.make_mesh()
    out["coords_1d"] = np.array([mesh.d, mesh.v])
    enc = sh.ShardedFastEncoder(vocab, mesh=mesh, device="cpu")
    out["stream_1d"] = enc.encode_codepoints(cps)
    shards, lens = sh.shard_codepoints(cps, world)
    ids, counts, total = sh.encode_data_parallel(
        sh.pad_shards(shards, enc._statics["max_len"]), lens, enc.table, mesh=mesh,
        **enc._statics,
    )
    out.update(ids_1d=ids.numpy(), counts_1d=counts.numpy(), total_1d=np.array(int(total)))
    # Each rank walks its shard to its own fixed point, with no collective
    # inside the walk: the ranks' round counts differ.
    out["chain_1d"] = enc.encode_codepoints(uni.decode_utf8(chain_case().encode()).astype(np.int32))
    out["rounds_1d"] = np.array(commit.commit_with_positions_plain.rounds)
    try:
        sh.ShardedFastEncoder(vocab, mesh=mesh, device="cuda")
        out["cuda_error"] = np.array("")
    except RuntimeError as e:
        out["cuda_error"] = np.array(str(e))

    if world == 4:
        grid = sh.make_mesh(2, 2)
        out["coords_2d"] = np.array([grid.d, grid.v])
        sidx = vp.build_index_sharded(vocab, 2)
        shards, lens = sh.shard_codepoints(cps, 2)
        ids, counts, total = sh.encode_2d_parallel(
            sh.pad_shards(shards, sidx.max_len), lens, load_table(sidx.tables[grid.v], "cpu"),
            mesh=grid, **index_statics(sidx),
        )
        out.update(ids_2d=ids.numpy(), counts_2d=counts.numpy(), total_2d=np.array(int(total)))
        best_id, best_len = partial_matches(rank)
        cid, clen = vp.combine_partial_matches(
            torch.from_numpy(best_id), torch.from_numpy(best_len), grid.vocab_group
        )
        out.update(combined_id=cid.numpy(), combined_len=clen.numpy())
        errors = []
        for bad in (lambda: sh.make_mesh(3, 2), lambda: sh.ShardedFastEncoder(vocab, mesh=grid,
                                                                               device="cpu")):
            try:
                bad()
                errors.append("")
            except ValueError as e:
                errors.append(str(e))
        out["grid_errors"] = np.array(errors)
        # A grid over a subgroup: every rank makes it, ranks 2 and 3 own it.
        part = sh.make_mesh(group=dist.new_group([2, 3]))
        out["ranks_sub"] = np.array(part.ranks)
        if part.d is None:
            try:
                sh.ShardedFastEncoder(vocab, mesh=part, device="cpu").encode_codepoints(cps)
                out["stream_sub"] = np.array("")
            except RuntimeError as e:
                out["stream_sub"] = np.array(str(e))
        else:
            out["coords_sub"] = np.array([part.d, part.v])
            out["stream_sub"] = sh.ShardedFastEncoder(vocab, mesh=part, device="cpu").encode_codepoints(cps)
    loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "wordpiece_tpu.")))
    assert not loaded, f"a worker imported {loaded[:3]}"
    np.savez(os.path.join(cfg["out"], f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


def spawn(world: int, tmp_dir) -> list[dict]:
    """Run `world` worker processes; returns each rank's outputs."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = []
    for rank in range(world):
        cfg = {"rank": rank, "world": world, "init": f"file://{tmp_dir}/pg", "out": str(tmp_dir)}
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), json.dumps(cfg)],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        ))
    end = time.monotonic() + DEADLINE_S
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
    """Each rank's outputs of a 2-rank and a 4-rank run, made once."""
    return {world: spawn(world, tmp_path_factory.mktemp(f"world{world}")) for world in (2, 4)}


def cps_and_vocabs():
    from wordpiece_tpu.core.vocab import parse_vocab as jax_parse_vocab
    from wordpiece_tpu_torch.core import unicode as uni
    from wordpiece_tpu_torch.core.vocab import parse_vocab

    text, lines = corpus_case()
    return uni.decode_utf8(text.encode()).astype(np.int32), parse_vocab(lines), jax_parse_vocab(lines)


def oracle(cps, vocab):
    from wordpiece_tpu_torch.core.oracle import encode_oracle

    return np.asarray(encode_oracle(cps, vocab), dtype=np.int32)


# ---- host-side functions: numpy-equal -----------------------------------------
@pytest.mark.parametrize("n_shards", [1, 2, 3, 5, 8])
def test_split_and_shard_equal_jax(n_shards):
    from wordpiece_tpu.parallel import sharding as jsh
    from wordpiece_tpu_torch.core import unicode as uni
    from wordpiece_tpu_torch.parallel import sharding as sh

    cps, _, _ = cps_and_vocabs()
    for text in (cps, uni.decode_utf8(b"x" * 100).astype(np.int32), cps[:7]):
        space = np.asarray(uni.is_space(text.astype(np.uint32)))
        for a, b in zip(sh.split_whitespace_safe(text, space, n_shards),
                        jsh.split_whitespace_safe(text, space, n_shards)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(sh.shard_codepoints(text, n_shards), jsh.shard_codepoints(text, n_shards)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        shards, lens = sh.shard_codepoints(text, n_shards)
        np.testing.assert_array_equal(sh.assemble_ids(shards, lens), text)


@pytest.mark.parametrize("n_parts", [1, 2, 3])
def test_build_index_sharded_equal_jax(n_parts):
    import dataclasses

    from wordpiece_tpu.parallel import vocab_parallel as jvp
    from wordpiece_tpu_torch.parallel import vocab_parallel as vp

    _, vocab, jvocab = cps_and_vocabs()
    mine = dataclasses.asdict(vp.build_index_sharded(vocab, n_parts))
    theirs = dataclasses.asdict(jvp.build_index_sharded(jvocab, n_parts))
    assert mine.keys() == theirs.keys()
    for k in mine:
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)
    assert mine["tables"].dtype == np.int32 and mine["tables"].shape[0] == n_parts


# ---- the process groups ----------------------------------------------------------
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_fast_encoder_equal_jax(world, runs):
    import jax

    from wordpiece_tpu.parallel.sharding import ShardedFastEncoder, make_mesh

    cps, vocab, jvocab = cps_and_vocabs()
    want = ShardedFastEncoder(jvocab, mesh=make_mesh(world, devices=jax.devices()[:world]))
    want = want.encode_codepoints(cps)
    np.testing.assert_array_equal(want, oracle(cps, vocab))
    for rank, out in enumerate(runs[world]):
        np.testing.assert_array_equal(out["stream_1d"], want, err_msg=f"rank {rank}")
        assert out["stream_1d"].dtype == np.int32
        assert out["coords_1d"].tolist() == [rank, 0]
        assert "nccl" in str(out["cuda_error"]) or "cuda" in str(out["cuda_error"])


@pytest.mark.parametrize("world", [2, 4])
def test_encode_data_parallel_counts_equal_jax(world, runs):
    import jax
    import jax.numpy as jnp

    from wordpiece_tpu.core.vocab import build_index
    from wordpiece_tpu.ops.match_fast import pack_table
    from wordpiece_tpu.parallel import sharding as jsh

    cps, _, jvocab = cps_and_vocabs()
    index = build_index(jvocab)
    shards, lens = jsh.shard_codepoints(cps, world)
    cp_pad = np.zeros((world, shards.shape[1] + index.max_len), np.int32)
    cp_pad[:, : shards.shape[1]] = shards
    ids, counts, total = jsh.encode_data_parallel(
        jnp.asarray(cp_pad), jnp.asarray(lens), pack_table(index),
        mesh=jsh.make_mesh(world, devices=jax.devices()[:world]),
        max_len=index.max_len, max_probe=index.max_probe, log2_size=index.log2_size,
        mult1=index.mult1, mult2=index.mult2, unk_id=index.unk_token_id,
    )
    ids, counts = np.asarray(ids), np.asarray(counts)
    for out in runs[world]:
        np.testing.assert_array_equal(out["counts_1d"], counts)
        assert int(out["total_1d"]) == int(total) == int(counts.sum())
        width = int(counts.max())
        assert out["ids_1d"].shape == (world, width)
        np.testing.assert_array_equal(out["ids_1d"], ids[:, :width])


def test_encode_2d_parallel_equal_jax(runs):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from wordpiece_tpu.parallel import sharding as jsh
    from wordpiece_tpu.parallel.vocab_parallel import build_index_sharded

    cps, vocab, jvocab = cps_and_vocabs()
    sidx = build_index_sharded(jvocab, 2)
    shards, lens = jsh.shard_codepoints(cps, 2)
    cp_pad = np.zeros((2, shards.shape[1] + sidx.max_len), np.int32)
    cp_pad[:, : shards.shape[1]] = shards
    ids, counts, total = jsh.encode_2d_parallel(
        jnp.asarray(cp_pad), jnp.asarray(lens), jnp.asarray(sidx.tables),
        mesh=Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "vocab")),
        max_len=sidx.max_len, max_probe=sidx.max_probe, log2_size=sidx.log2_size,
        mult1=sidx.mult1, mult2=sidx.mult2, unk_id=sidx.unk_token_id,
    )
    ids, counts = np.asarray(ids), np.asarray(counts)
    want = jsh.assemble_ids(ids, counts)
    np.testing.assert_array_equal(want, oracle(cps, vocab))
    for rank, out in enumerate(runs[4]):
        assert out["coords_2d"].tolist() == [rank // 2, rank % 2]
        np.testing.assert_array_equal(out["counts_2d"], counts)
        assert int(out["total_2d"]) == int(total) == want.shape[0]
        width = int(counts.max())
        np.testing.assert_array_equal(out["ids_2d"], ids[:, :width])


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_walk_to_their_own_fixed_point(world, runs):
    """The commit runs on each rank before any collective and loops until
    its own shard's walk stops: a rank of short units stops after one
    round, the rank of the 600-codepoint unit after more, and every rank
    still gathers the oracle's ids."""
    from wordpiece_tpu_torch.core import unicode as uni

    _, vocab, _ = cps_and_vocabs()
    want = oracle(uni.decode_utf8(chain_case().encode()).astype(np.int32), vocab)
    rounds = [int(out["rounds_1d"]) for out in runs[world]]
    for rank, out in enumerate(runs[world]):
        np.testing.assert_array_equal(out["chain_1d"], want, err_msg=f"rank {rank}")
    assert min(rounds) == 1 and max(rounds) > 1, rounds


def test_grid_rejects_what_it_cannot_run(runs):
    """A grid larger than the world, and a vocab axis for the 1-D encoder,
    raise on every rank."""
    for out in runs[4]:
        too_big, two_d = out["grid_errors"].tolist()
        assert "3 x 2" in too_big and "1-D" in two_d


def test_grid_over_a_subgroup(runs):
    """make_mesh(group=...) lays the grid over that group's ranks only; a
    rank outside it cannot encode."""
    cps, vocab, _ = cps_and_vocabs()
    for rank, out in enumerate(runs[4]):
        assert out["ranks_sub"].tolist() == [2, 3]
        if rank < 2:
            assert "outside the grid" in str(out["stream_sub"])
        else:
            assert out["coords_sub"].tolist() == [rank - 2, 0]
            np.testing.assert_array_equal(out["stream_sub"], oracle(cps, vocab))


def test_combine_partial_matches_over_vocab_groups(runs):
    """Ranks (d, 0) and (d, 1) of the 2 x 2 grid combine: the longest
    length, and the largest id among the partitions that reach it."""
    for rank, out in enumerate(runs[4]):
        d = rank // 2
        parts = [partial_matches(r) for r in (2 * d, 2 * d + 1)]
        lens = np.stack([p[1] for p in parts])
        ids = np.stack([p[0] for p in parts])
        want_len = lens.max(0)
        want_id = np.where(lens == want_len, ids, -1).max(0)
        np.testing.assert_array_equal(out["combined_len"], want_len)
        np.testing.assert_array_equal(out["combined_id"], want_id)


if __name__ == "__main__":
    worker(json.loads(sys.argv[1]))

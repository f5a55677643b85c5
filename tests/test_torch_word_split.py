"""The split word kernels' packed match word and the 2-D word path's one
combine (ops/word_kernel.pack_matches, ops/word_kernel_cuda.
word_match_packed / word_commit_packed, parallel/word_sharding.
word_encode_2d_parallel) on the CPU, against the JAX package's word_match,
its two-pmax combine and its 2-D ShardedWordEncoder.

The CUDA kernels themselves are held against the plain versions on the
card by chip_smoke.py (phase 11).  Here the wrappers run their plain
versions; the match kernel's own path (each position's keys from its
unit's prefix hashes, lengths scanned longest first over fingerprints, one
confirmation, the fallback after a collision) is modelled in numpy on the
tables it reads and held against the JAX package's word_match.

The gloo groups are real processes: this file, run as a script, is the
worker (`python tests/test_torch_word_split.py CONFIG`) and imports torch
and the port only.  Ids are integers: exact."""

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
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_word_sharding import oracle, sharded_case, small_chunks  # noqa: E402

DEADLINE_S = 150
GRIDS = {2: (1, 2), 4: (2, 2)}  # world size -> (n_data, n_vocab)

torch.set_num_threads(1)


# ---- the worker: one rank of a gloo group running the 2-D encoder ----------
def worker(cfg: dict) -> None:
    from datetime import timedelta

    import torch.distributed as dist

    rank, world = cfg["rank"], cfg["world"]
    dist.init_process_group("gloo", init_method=cfg["init"], rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    from wordpiece_tpu_torch.core.vocab import parse_vocab
    from wordpiece_tpu_torch.parallel import word_sharding as ws
    from wordpiece_tpu_torch.parallel.sharding import make_mesh

    text, lines = sharded_case(short=True)
    enc = ws.ShardedWordEncoder(parse_vocab(lines), mesh=make_mesh(*GRIDS[world]), device="cpu")
    small_chunks(enc._inner)
    calls = {"all_reduce": 0, "all_gather": 0, "dispatches": 0}

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    orig = enc._inner._dispatch_buckets

    def dispatch(mats):
        calls["dispatches"] += any(m.shape[0] for m in mats)
        return orig(mats)

    enc._inner._dispatch_buckets = dispatch
    reduce_, gather = dist.all_reduce, dist.all_gather
    dist.all_reduce, dist.all_gather = counted("all_reduce", reduce_), counted("all_gather", gather)
    try:
        ids = enc.encode_bytes(text.encode())
    finally:
        dist.all_reduce, dist.all_gather = reduce_, gather
    loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "wordpiece_tpu.")))
    assert not loaded, f"a worker imported {loaded[:3]}"
    np.savez(os.path.join(cfg["out"], f"rank{rank}.npz"), ids=ids,
             calls=np.array([calls["all_reduce"], calls["all_gather"], calls["dispatches"]]))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def grid_runs(tmp_path_factory):
    """Each rank's ids and collective counts on the 1 x 2 and 2 x 2 grids
    (both worlds started together), and the JAX package's 2-D encoder on
    the same meshes, computed while the workers run."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    dirs = {w: tmp_path_factory.mktemp(f"grid{w}") for w in GRIDS}
    procs = {w: [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__),
         json.dumps({"rank": r, "world": w, "init": f"file://{dirs[w]}/pg", "out": str(dirs[w])})],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE) for r in range(w)]
        for w in GRIDS}
    end = time.monotonic() + DEADLINE_S
    errors = []
    try:
        refs = jax_2d_references()
    finally:
        for w, ps in procs.items():
            try:
                for r, p in enumerate(ps):
                    _, err = p.communicate(timeout=max(1.0, end - time.monotonic()))
                    if p.returncode != 0:
                        errors.append(f"world {w} rank {r} rc {p.returncode}:\n{err.decode()[-3000:]}")
            except subprocess.TimeoutExpired:
                errors.append(f"the {w} workers missed their {DEADLINE_S} s deadline")
            finally:
                for p in ps:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
    if errors:
        pytest.fail("\n".join(errors))
    outs = {w: [dict(np.load(os.path.join(dirs[w], f"rank{r}.npz"))) for r in range(w)]
            for w in GRIDS}
    return outs, refs


def jax_2d_references() -> dict:
    import jax
    from jax.sharding import Mesh

    from wordpiece_tpu.core.vocab import parse_vocab as jax_parse_vocab
    from wordpiece_tpu.parallel.word_sharding import ShardedWordEncoder

    text, lines = sharded_case(short=True)
    refs = {}
    for world, shape in GRIDS.items():
        mesh = Mesh(np.asarray(jax.devices()[:world]).reshape(shape), ("data", "vocab"))
        refs[world] = ShardedWordEncoder(jax_parse_vocab(lines), mesh=mesh).encode_bytes(
            text.encode())
    return refs


@pytest.mark.parametrize("world", sorted(GRIDS))
def test_2d_encoder_combines_in_one_all_reduce(world, grid_runs):
    """The 2-D ShardedWordEncoder on a grid with a real vocab split equals
    the JAX encoder and the oracle, and each dispatch issues one
    all_reduce (the packed matches' max) and one all_gather."""
    outs, refs = grid_runs
    text, lines = sharded_case(short=True)
    want = oracle(lines, text.encode())
    np.testing.assert_array_equal(refs[world], want)
    for rank, out in enumerate(outs[world]):
        np.testing.assert_array_equal(out["ids"], want, err_msg=f"rank {rank}")
        reduces, gathers, dispatches = out["calls"].tolist()
        assert dispatches > 1, f"rank {rank}: one dispatch only"
        assert (reduces, gathers) == (dispatches, dispatches), f"rank {rank}"


# ---- the packed match word -----------------------------------------------------
WIDTHS = (7, 15, 31, 127)


@pytest.mark.parametrize("width", WIDTHS)
def test_pack_round_trip(width):
    from wordpiece_tpu_torch.ops.word_kernel import pack_matches, unpack_matches

    rng = np.random.default_rng(width)
    best_len = torch.from_numpy(rng.integers(0, width + 1, size=(40, width)).astype(np.int32))
    ids = torch.from_numpy(rng.integers(0, 1 << 24, size=(40, width)).astype(np.int32))
    best_id = torch.where(best_len > 0, ids, -1)
    best_id[0, 0], best_len[0, 0] = (1 << 24) - 1, width  # the widest word
    packed = pack_matches(best_id, best_len, width)
    assert packed.dtype == torch.int32 and bool((packed >= 0).all())
    got_id, got_len = unpack_matches(packed)
    assert torch.equal(got_id, best_id) and torch.equal(got_len, best_len)
    # word_commit reads a length as min(best_len, width) and a non-positive
    # one as no hit; packing keeps exactly that.
    over = pack_matches(best_id, torch.where(best_len > 0, best_len + 300, -5), width)
    assert torch.equal(unpack_matches(over)[1], torch.where(best_len > 0, width, 0))
    with pytest.raises(ValueError):
        pack_matches(best_id, best_len, 128)


def _bert():
    from wordpiece_tpu.core.length_tables import build_length_tables as jax_build
    from wordpiece_tpu.core.vocab import parse_vocab as jax_parse_vocab
    from wordpiece_tpu_torch.bench.corpus import make_corpus, make_vocab_bert
    from wordpiece_tpu_torch.core.length_tables import build_length_tables
    from wordpiece_tpu_torch.core.vocab import parse_vocab

    data = make_corpus(200_000)
    lines = make_vocab_bert(data)
    words = data.decode("utf-8", errors="ignore").split()
    return lines, build_length_tables(parse_vocab(lines)), jax_build(jax_parse_vocab(lines)), words


def _jax_match():
    import jax

    from wordpiece_tpu.ops.word_kernel import word_match

    return jax.jit(word_match,
                   static_argnames=("width", "max_len", "rows_off", "mult1", "mult2", "lane_salts"))


def _padded(mat: np.ndarray, width: int, max_len: int) -> np.ndarray:
    pad = np.full((mat.shape[0], width + max_len), 32, np.int32)
    pad[:, :width] = mat
    return pad


@pytest.mark.parametrize("n_vocab,width", [(2, 7), (2, 31), (3, 15), (3, 127)])
def test_packed_max_equals_jax(n_vocab, width):
    """word_match_packed on every partition, max-combined (the 2-D step's
    one all_reduce), equals the JAX word_match on the whole table and the
    JAX two-pmax combine of the partitions' pairs, packed."""
    import jax.numpy as jnp

    from chip_smoke import unit_matrices
    from wordpiece_tpu.parallel.word_sharding import shard_word_tables as jax_shard
    from wordpiece_tpu_torch.core.length_tables import load_length_tables
    from wordpiece_tpu_torch.engine_word import _narrow
    from wordpiece_tpu_torch.ops import word_kernel_cuda as wk
    from wordpiece_tpu_torch.ops.word_kernel import pack_matches
    from wordpiece_tpu_torch.parallel.word_sharding import partition_tables

    _, host, jhost, words = _bert()
    jmatch = _jax_match()
    mat = np.concatenate(list(unit_matrices(width, words, np.random.default_rng(width), n=10).values()))
    cp = torch.from_numpy(_narrow(mat))
    pad = jnp.asarray(_padded(mat, width, host.max_len))
    kw = dict(width=width, max_len=host.max_len, mult1=host.mult1, mult2=host.mult2,
              lane_salts=tuple(host.lane_salts))
    parts = [load_length_tables(partition_tables(host, n_vocab, v), "cpu") for v in range(n_vocab)]
    flat = torch.empty(mat.size, dtype=torch.int32)
    per = [wk.word_match_packed([cp], t, out=flat)[0].clone() for t in parts]
    combined = torch.stack(per).max(dim=0).values

    whole = jmatch(pad, jnp.asarray(jhost.k1), jnp.asarray(jhost.k2), jnp.asarray(jhost.tid),
                   rows_off=tuple(jhost.rows_off), **kw)
    k1p, k2p, tidp, rows_off = jax_shard(jhost, n_vocab)
    r = k1p.shape[0] // n_vocab
    pairs = [jmatch(pad, jnp.asarray(k1p[v * r:(v + 1) * r]), jnp.asarray(k2p[v * r:(v + 1) * r]),
                    jnp.asarray(tidp[v * r:(v + 1) * r]), rows_off=rows_off, **kw)
             for v in range(n_vocab)]
    best_len = jnp.max(jnp.stack([p[1] for p in pairs]), axis=0)
    best_id = jnp.max(jnp.stack([jnp.where(p[1] == best_len, p[0], -1) for p in pairs]), axis=0)

    def packed(bid, blen):
        return pack_matches(torch.from_numpy(np.array(bid)), torch.from_numpy(np.array(blen)),
                            width)

    assert torch.equal(combined, packed(*whole))
    assert torch.equal(combined, packed(best_id, best_len))
    assert int((combined > 0).sum()) > 0


def _match_kernel_model(mat: np.ndarray, tabs) -> tuple[np.ndarray, int]:
    """The match kernel's path for one bucket of units int[U, W], position
    by position, in numpy on the tables the kernel reads (slot_off, the
    16-bit fingerprints, the slots' {k1, k2, tid}): a position's inclusive
    prefix hashes P(j) over its unit's codepoints; its window (to the first
    spacing char strictly after it, capped at max_len and the unit end, 1
    for punctuation) and kind; then for l from the window down, the keys
    h = P(j + l - 1) - P(j - 1) mult^l, their (length, lane) list and
    fingerprint, and at the longest length whose list holds the
    fingerprint, the confirmation: the last slot of the list whose full
    keys match.  A confirmation that finds none (a collision) goes on
    below.  Returns the packed matches and the count of such fallbacks."""
    from wordpiece_tpu_torch.core.length_tables import LANES, fingerprint, fold_key2, lane_of
    from wordpiece_tpu_torch.ops import text_features as tf

    u_n, w = mat.shape
    t = torch.from_numpy(mat.astype(np.int64))
    punct = tf.is_punct(t).numpy()
    spacing = (tf.is_space(t) | tf.is_punct(t) | tf.is_chinese(t)).numpy()
    off = tabs.slot_off.numpy().astype(np.int64)
    fps = tabs.slot_fp.numpy().view(np.uint16)
    keys = tabs.slot_keys.numpy()[: tabs.n_slots]
    mask = 0xFFFFFFFF
    mults = (tabs.mult1 & mask, tabs.mult2 & mask)
    out = np.zeros((u_n, w), np.int32)
    fallbacks = 0
    for u in range(u_n):
        pre = []  # P(j) for each multiplier, j = -1 .. W - 1
        for m in mults:
            h, row = 0, [0]
            for c in mat[u].tolist():
                h = (h * m + c) & mask
                row.append(h)
            pre.append(row)
        for j in range(w):
            k = j + 1
            if not punct[u, j]:
                end = min(w, j + tabs.max_len)
                while k < end and not spacing[u, k]:
                    k += 1
            lmax = min(max(k - j, 1), tabs.max_len)
            kind = int(j == 0 or spacing[u, j] or spacing[u, j - 1])
            for l in range(lmax, 0, -1):
                h1, h2 = ((p[j + l] - p[j] * pow(m, l, 1 << 32)) & mask for p, m in zip(pre, mults))
                lane = int(lane_of(np.uint32(h1), np.uint32(h2), l, kind, tabs.lane_salts[l]))
                s0, s1 = off[l * LANES + lane], off[l * LANES + lane + 1]
                fp = int(fingerprint(np.int64(h1)))
                held = np.nonzero(fps[s0:s1] == fp)[0]
                if not held.size:
                    continue
                k1 = np.uint32(h1).view(np.int32)
                k2 = fold_key2(np.uint32(h2), l, kind).view(np.int32)
                tid = -1
                for s in (s0 + held).tolist():
                    if keys[s, 0] == k1 and keys[s, 1] == k2:
                        tid = int(keys[s, 2])
                if tid >= 0:
                    out[u, j] = (l << 24) | tid
                    break
                fallbacks += 1
    return out, fallbacks


def _jax_packed(jmatch, mat: np.ndarray, jhost) -> torch.Tensor:
    """The JAX package's word_match of one bucket against `jhost`, packed."""
    import jax.numpy as jnp

    from wordpiece_tpu_torch.ops.word_kernel import pack_matches

    w = int(mat.shape[1])
    bid, blen = jmatch(jnp.asarray(_padded(mat, w, jhost.max_len)), jnp.asarray(jhost.k1),
                       jnp.asarray(jhost.k2), jnp.asarray(jhost.tid), width=w,
                       max_len=jhost.max_len, rows_off=tuple(jhost.rows_off), mult1=jhost.mult1,
                       mult2=jhost.mult2, lane_salts=tuple(jhost.lane_salts))
    return pack_matches(torch.from_numpy(np.array(bid)), torch.from_numpy(np.array(blen)), w)


@pytest.mark.parametrize("width", WIDTHS)
def test_longest_first_model_equals_jax(width):
    """The match kernel's path, modelled in numpy (_match_kernel_model),
    equals the JAX package's word_match, packed, on units of every width:
    the prefix-hash keys probe the lists the rolling keys probe, and the
    longest fingerprint hit, confirmed, is the longest hit."""
    from chip_smoke import unit_matrices
    from wordpiece_tpu_torch.core.length_tables import load_length_tables

    _, host, jhost, words = _bert()
    tabs = load_length_tables(host, "cpu")
    mat = np.concatenate(list(unit_matrices(width, words, np.random.default_rng(3), n=8).values()))
    got, _ = _match_kernel_model(mat, tabs)
    want = _jax_packed(_jax_match(), mat, jhost)
    np.testing.assert_array_equal(got, want.numpy())
    assert int((want > 0).sum()) > 0


def test_load_length_tables_rejects_ids_past_24_bits():
    """A packed match holds a token id in 24 bits: load_length_tables
    raises on an id >= 2^24 and takes 2^24 - 1."""
    from wordpiece_tpu_torch.core.length_tables import (
        build_length_tables, load_length_tables,
    )
    from wordpiece_tpu_torch.core.vocab import parse_vocab

    host = build_length_tables(parse_vocab(["[UNK]", "a", "b", "##a"]))
    top = np.asarray(host.tid).copy()
    slot = tuple(np.argwhere(top >= 0)[0])
    for tid, ok in (((1 << 24) - 1, True), (1 << 24, False)):
        top[slot] = tid
        host.tid = top.copy()
        if ok:
            assert int(load_length_tables(host, "cpu").slot_tid.max()) == tid
        else:
            with pytest.raises(ValueError, match="2\\^24"):
                load_length_tables(host, "cpu")


def test_collision_vocab_forces_fallbacks():
    """The collision vocabulary (bench/collisions.py): tokens found by a
    search over random strings share (length, kind, lane, fingerprint) with
    queries of the dispatch longer than their true longest hit.  The plain
    count of the collisions is > 0 and grows over the bert vocab's own; the
    packed match and the match kernel's model, which falls back past the
    collisions, equal the JAX word_match on the same lines."""
    from chip_smoke import unit_matrices
    from wordpiece_tpu.core.length_tables import build_length_tables as jax_build
    from wordpiece_tpu.core.vocab import parse_vocab as jax_parse_vocab
    from wordpiece_tpu_torch.bench.collisions import collision_vocab, fp_collisions
    from wordpiece_tpu_torch.core.length_tables import load_length_tables
    from wordpiece_tpu_torch.engine_word import _narrow
    from wordpiece_tpu_torch.ops import word_kernel_cuda as wk

    lines, host, _, words = _bert()
    rng = np.random.default_rng(9)
    cps = [torch.from_numpy(_narrow(m)) for m in
           (unit_matrices(7, words, rng, n=300)["ascii"], unit_matrices(15, words, rng, n=300)["ascii"])]
    before = fp_collisions(cps, load_length_tables(host, "cpu"))
    lines_c, tabs_c, found = collision_vocab(lines, cps, np.random.default_rng(4), n_tokens=24)
    assert len(lines_c) > len(lines) and found[0] > before[0] and found[1] > 0
    jhost = jax_build(jax_parse_vocab(lines_c))
    jmatch = _jax_match()
    fallbacks = 0
    for cp, got in zip(cps, wk.word_match_packed(cps, tabs_c)):
        want = _jax_packed(jmatch, cp.numpy(), jhost)
        assert torch.equal(got, want)
        model, n = _match_kernel_model(cp.numpy(), tabs_c)
        np.testing.assert_array_equal(model, want.numpy())
        fallbacks += n
    assert fallbacks > 0


def test_packed_wrappers_check_their_inputs():
    from wordpiece_tpu_torch.core.length_tables import build_length_tables, load_length_tables
    from wordpiece_tpu_torch.core.vocab import parse_vocab
    from wordpiece_tpu_torch.ops import word_kernel_cuda as wk

    tabs = load_length_tables(build_length_tables(parse_vocab(["[UNK]", "a", "##a"])), "cpu")
    cps = [torch.full((3, 7), 32, dtype=torch.uint8), torch.full((2, 15), 97, dtype=torch.uint8)]
    with pytest.raises(ValueError):
        wk.word_match_packed(cps, tabs, out=torch.empty(20, dtype=torch.int32))
    flat = torch.full((3 * 7 + 2 * 15,), -9, dtype=torch.int32)
    packed = wk.word_match_packed(cps, tabs, out=flat)
    assert packed[1].data_ptr() == flat.data_ptr() + 21 * 4  # views of `out`, back to back
    assert int(flat.min()) >= 0
    with pytest.raises(ValueError):
        wk.word_commit_packed(cps, packed[:1], max_len=tabs.max_len, unk_id=0)
    counts = torch.empty(5, dtype=torch.int32)
    emits = wk.word_commit_packed(cps, packed, max_len=tabs.max_len, unk_id=0, counts=counts)
    assert (emits[0] == -2).all() and counts.tolist() == [0, 0, 0, 15, 15]
    assert (wk.word_match_packed.launches, wk.word_commit_packed.launches) == (0, 0)


if __name__ == "__main__":
    worker(json.loads(sys.argv[1]))

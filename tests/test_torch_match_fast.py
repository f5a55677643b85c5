"""The port's rolling-hash probe (ops/match_fast.py) against the JAX
package's pack_table and match_positions, on the same numpy-seeded texts
and features.  The CUDA kernel (csrc/match_fast.cu) runs only on the card,
where chip_smoke.py holds it against the plain version tested here.
Integers: exact."""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wordpiece_tpu.core.vocab import build_index as jax_build_index
from wordpiece_tpu.core.vocab import parse_vocab as jax_parse_vocab
from wordpiece_tpu.ops import match_fast as jmf
from wordpiece_tpu.ops import text_features as jtf
from wordpiece_tpu_torch.bench.corpus import make_corpus, make_vocab
from wordpiece_tpu_torch.core import unicode as uni
from wordpiece_tpu_torch.core.vocab import build_index, parse_vocab
from wordpiece_tpu_torch.ops import match_fast

torch.set_num_threads(1)

EXTRA = ["[UNK]", "при", "##вет", "мир", "中", "文", "中文", "-", ",", "«", "»", "!!",
         "𠀀", "𠀀x", "##𠀁", "𠀂𠀃", "##x", "ab", "##ab"]


def texts() -> dict:
    """Codepoint texts of each kind, from a fixed seed."""
    rng = np.random.default_rng(41)
    en = make_corpus(20_000, lang="en").decode("utf-8", errors="ignore")
    words = en.split()

    def pool_text(n, pools):
        out = []
        for _ in range(n):
            pool = pools[int(rng.integers(len(pools)))]
            out.append(pool[int(rng.integers(len(pool)))])
        return "".join(out)

    cyr = [chr(c) for c in range(0x430, 0x450)] + [" "]
    cjk = ["中", "文", "字"] + [chr(int(c)) for c in rng.integers(0x4E00, 0x4E40, size=16)]
    astral = ["𠀀", "𠀁", "𠀂", "𠀃", "x", " "] + [chr(int(c)) for c in rng.integers(0x20000, 0x20040, size=8)]
    punct = list(",.-!«»·‐") + ["a", "b", "ab", " "]
    rare = [chr(int(c)) for c in rng.integers(0x100, 0x250, size=32)]
    unk_heavy = "".join(
        c if rng.random() < 0.7 else rare[int(rng.integers(len(rare)))] for c in en[:1500]
    )
    return {
        "ascii": en[:2001],
        "multilingual": pool_text(1500, [cyr, cjk, list("ab -,"), ["при", "вет", " мир "]]),
        "astral": pool_text(1203, [astral, list("ab x"), ["𠀀x", " 𠀂𠀃 "]]),
        "unk_heavy": unk_heavy,
        "punct_dense": pool_text(999, [punct, [" !! ", "«ab»"]]),
        "odd_n": " ".join(words[:37])[:127],
    }


def vocab_lines() -> list[str]:
    text = " ".join(texts().values())
    return EXTRA + make_vocab(text.encode(), vocab_size=700)


def features(cps: np.ndarray, max_len: int):
    """(cp_pad int32[n + max_len], window int32[n], wp bool[n]) from the
    JAX package's compute_features, n = len(cps) (no bucket padding)."""
    n = cps.shape[0]
    cp_pad = np.zeros(n + max_len, dtype=np.int32)
    cp_pad[:n] = cps
    f = jtf.compute_features(jnp.asarray(cp_pad[:n]), jnp.int32(n), max_len)
    return cp_pad, np.array(f.window), np.array(f.wp)


@partial(jax.jit, static_argnames=("max_len", "max_probe", "log2_size", "mult1", "mult2"))
def jax_match(cp_pad, window, wp, table, **statics):
    return jmf.match_positions(cp_pad, window, wp, table, **statics)


def statics_of(index) -> dict:
    return dict(max_len=int(index.max_len), max_probe=int(index.max_probe),
                log2_size=int(index.log2_size), mult1=int(index.mult1), mult2=int(index.mult2))


def both(cp_pad, window, wp, lines):
    """(port best_id, best_len), (JAX best_id, best_len), port index."""
    index = build_index(parse_vocab(lines))
    jindex = jax_build_index(jax_parse_vocab(lines))
    st = statics_of(index)
    got = match_fast.match_positions(
        torch.from_numpy(cp_pad), torch.from_numpy(window), torch.from_numpy(wp),
        match_fast.pack_table(index, "cpu"), **st,
    )
    want = jax_match(jnp.asarray(cp_pad), jnp.asarray(window), jnp.asarray(wp),
                     jmf.pack_table(jindex), **statics_of(jindex))
    return [g.numpy() for g in got], [np.asarray(w) for w in want], index


@pytest.mark.parametrize("name", ["en", "multilingual", "tiny"])
def test_pack_and_load_table_equal_jax(name):
    lines = {"en": make_vocab(make_corpus(30_000, lang="en"), vocab_size=1500),
             "multilingual": vocab_lines(), "tiny": ["[UNK]", "a"]}[name]
    index = build_index(parse_vocab(lines))
    want = np.asarray(jmf.pack_table(jax_build_index(jax_parse_vocab(lines))))
    for table in (match_fast.pack_table(index, "cpu"), match_fast.load_table(want, "cpu")):
        assert table.rows.dtype == torch.int32 and table.rows.shape == want.shape
        np.testing.assert_array_equal(table.rows.numpy(), want)
    np.testing.assert_array_equal(match_fast.pack_table_np(index), want)


@pytest.mark.parametrize("name", ["ascii", "multilingual", "astral", "unk_heavy", "punct_dense", "odd_n"])
def test_match_positions_equal_jax(name):
    lines = vocab_lines()
    cps = uni.decode_utf8(texts()[name].encode()).astype(np.int32)
    index = build_index(parse_vocab(lines))
    cp_pad, window, wp = features(cps, index.max_len)
    got, want, index = both(cp_pad, window, wp, lines)
    assert index.max_probe >= 2
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == got[1].dtype == np.int32
    assert (got[1] > 0).sum() > cps.shape[0] // 8, "too few matches to test anything"
    if name == "astral":
        assert (cps > 0xFFFF).any() and ((cps[: got[1].shape[0]] > 0xFFFF) & (got[1] > 0)).any()


def test_match_positions_random_windows():
    """Windows and kinds that no text gives (the matcher takes any), an odd
    n, and codepoints that are not in the vocabulary's alphabet."""
    rng = np.random.default_rng(3)
    lines = vocab_lines()
    index = build_index(parse_vocab(lines))
    pool = uni.decode_utf8(" ".join(texts().values()).encode()).astype(np.int32)
    n = 1001
    cps = pool[rng.integers(0, pool.shape[0], size=n)]
    cps[::17] = rng.integers(0x20000, 0x20010, size=cps[::17].shape[0])
    cp_pad = np.concatenate([cps, np.zeros(index.max_len, np.int32)])
    window = rng.integers(1, index.max_len + 3, size=n).astype(np.int32)
    wp = rng.random(n) < 0.5
    got, want, _ = both(cp_pad, window, wp, lines)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_chains_have_no_empty_slot():
    """What the CUDA kernel's early exits rest on: every entry lies at most
    max_probe - 1 slots after its home slot (_bucket), with no empty slot
    between, and no two entries share (k1, k2, meta)."""
    index = build_index(parse_vocab(vocab_lines()))
    assert index.max_probe >= 2
    table = match_fast.pack_table(index, "cpu").rows.to(torch.int64)
    occupied = torch.nonzero(table[:, match_fast.TABLE_ID] >= 0).reshape(-1)
    k1, k2, meta = (table[occupied, c] for c in range(3))
    home = match_fast._bucket(k1 & 0xFFFFFFFF, k2 & 0xFFFFFFFF, meta & 1, meta >> 1,
                              index.log2_size)
    assert len(set(zip(k1.tolist(), k2.tolist(), meta.tolist()))) == occupied.shape[0]
    size = 1 << index.log2_size
    empty = (table[:, match_fast.TABLE_ID] < 0).tolist()
    for slot, h in zip(occupied.tolist(), home.tolist()):
        dist = (slot - h) % size
        assert dist < index.max_probe
        assert not any(empty[(h + p) % size] for p in range(dist))


@pytest.mark.parametrize("bad", ["window_dtype", "wp_dtype", "cp_pad_length", "strided_window",
                                 "table_rows", "table_width", "tags_dtype", "tags_size",
                                 "slots_strided", "log2_size"])
def test_kernel_binding_checks_before_it_builds(bad):
    """The CUDA binding refuses what the kernel cannot take before it
    builds or launches anything (so the check runs here, on the CPU)."""
    from wordpiece_tpu_torch.ops import match_fast_cuda

    index = build_index(parse_vocab(["[UNK]", "ab", "##c"]))
    st = statics_of(index)
    n = 130
    table = match_fast.pack_table(index, "cpu")
    args = dict(
        cp_pad=torch.zeros(n + st["max_len"], dtype=torch.int32),
        window=torch.ones(n, dtype=torch.int32),
        wp=torch.ones(n, dtype=torch.bool),
        table=table,
    )

    def with_(**parts):
        return {"table": dataclasses.replace(table, **parts)}

    size = table.tags.shape[0]
    args.update({
        "window_dtype": {"window": args["window"].long()},
        "wp_dtype": {"wp": args["wp"].to(torch.uint8)},
        "cp_pad_length": {"cp_pad": args["cp_pad"][:-1]},
        "strided_window": {"window": torch.ones(2 * n, dtype=torch.int32)[::2]},
        "table_rows": with_(slots=table.slots[:-1]),
        "table_width": with_(slots=table.rows),
        "tags_dtype": with_(tags=table.tags.to(torch.int32)),
        "tags_size": with_(tags=torch.zeros(2 * size, dtype=torch.uint8)[:size - 16]),
        "slots_strided": with_(slots=torch.zeros((size, 16), dtype=torch.int32)[:, :8]),
        "log2_size": {},
    }[bad])
    if bad == "log2_size":
        st["log2_size"] = 31
    with pytest.raises(ValueError):
        match_fast_cuda.launch(**args, **st)


def test_match_positions_rejects_mixed_devices():
    index = build_index(parse_vocab(["[UNK]", "a"]))
    table = match_fast.load_table(match_fast.pack_table_np(index), "meta")
    assert table.device.type == "meta" and table.tags.device.type == "meta"
    with pytest.raises(ValueError, match="meta"):
        match_fast.match_positions(
            torch.zeros(4 + index.max_len, dtype=torch.int32), torch.ones(4, dtype=torch.int32),
            torch.ones(4, dtype=torch.bool), table, **statics_of(index),
        )


# ---- the CUDA kernel's layout: tags and 32-byte rows -------------------------

def _tag_reference(k1: np.ndarray) -> np.ndarray:
    """tag_of in plain uint32 arithmetic, as csrc/match_fast.cu computes it."""
    t = (k1.astype(np.uint32) * np.uint32(match_fast.TAG_MIX)) >> np.uint32(24)
    return np.where(t == 0, 1, t).astype(np.int64)


def test_tag_of_equals_uint32_arithmetic():
    rng = np.random.default_rng(11)
    k1 = rng.integers(0, 1 << 32, size=20_000, dtype=np.uint64).astype(np.uint32)
    inverse = pow(match_fast.TAG_MIX, -1, 1 << 32)  # k1 whose tag byte is 0
    k1[:4] = [0, 0xFFFFFFFF, (inverse * 5) & 0xFFFFFFFF, inverse]
    got = match_fast.tag_of(torch.from_numpy(k1.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, _tag_reference(k1))
    assert got[0] == 1 and got[2] == 1 and got[3] == 1  # a 0 byte becomes 1
    assert got.min() >= 1 and got.max() <= 255


@pytest.mark.parametrize("name", ["en", "multilingual", "tiny"])
@pytest.mark.parametrize("source", ["port", "jax"])
def test_tags_and_slots_from_either_package(name, source):
    """The kernel's layout of the port's table and of the JAX package's:
    tag 0 exactly at the empty slots, tag_of(k1) at the occupied ones, and
    32-byte rows carrying the five fields of the JAX pack_table, then
    three zeros."""
    lines = {"en": make_vocab(make_corpus(30_000, lang="en"), vocab_size=1500),
             "multilingual": vocab_lines(), "tiny": ["[UNK]", "a"]}[name]
    want = np.asarray(jmf.pack_table(jax_build_index(jax_parse_vocab(lines))))
    if source == "port":
        table = match_fast.pack_table(build_index(parse_vocab(lines)), "cpu")
    else:
        table = match_fast.load_table(want, "cpu")
    size = want.shape[0]
    assert table.tags.dtype == torch.uint8 and table.tags.shape == (size,)
    assert table.slots.dtype == torch.int32 and table.slots.shape == (size, 8)
    assert table.tags.is_contiguous() and table.slots.is_contiguous()
    tags = table.tags.numpy().astype(np.int64)
    occupied = want[:, match_fast.TABLE_ID] >= 0
    assert occupied.any() and (~occupied).any()
    assert (tags[~occupied] == 0).all() and (tags[occupied] != 0).all()
    k1 = want[:, match_fast.TABLE_K1].view(np.uint32)
    np.testing.assert_array_equal(tags[occupied], _tag_reference(k1[occupied]))
    slots = table.slots.numpy()
    np.testing.assert_array_equal(slots[:, :5], want)
    assert (slots[:, 5:] == 0).all()


def _probe_case(name):
    """(codepoints, cp_pad, window, wp, table, statics) of one text."""
    cps = uni.decode_utf8(texts()[name].encode()).astype(np.int32)
    index = build_index(parse_vocab(vocab_lines()))
    cp_pad, window, wp = (torch.from_numpy(a) for a in features(cps, index.max_len))
    return cps, cp_pad, window, wp, match_fast.pack_table(index, "cpu"), statics_of(index)


def _tag_hits(name):
    """Every probe of one text against the tags of the chain it walks: the
    number of true hits, and of tag hits that are not true hits.  Asserts
    that every true hit lies before the chain's first empty slot and
    carries its probe's tag."""
    cps, cp_pad, _, wp, table, st = _probe_case(name)
    mask = (1 << st["log2_size"]) - 1
    k1 = table.rows[:, match_fast.TABLE_K1].to(torch.int64) & 0xFFFFFFFF
    k2 = table.rows[:, match_fast.TABLE_K2].to(torch.int64) & 0xFFFFFFFF
    true_hits = false_hits = 0
    for l, h1, h2, bucket, meta in match_fast.probe_keys(
        cp_pad, wp, max_len=st["max_len"], log2_size=st["log2_size"],
        mult1=st["mult1"], mult2=st["mult2"],
    ):
        tag = match_fast.tag_of(h1)
        reached = torch.ones(wp.shape[0], dtype=torch.bool)
        for p in range(st["max_probe"]):
            slot = (bucket + p) & mask
            rows = table.rows[slot]
            true = ((k1[slot] == h1) & (k2[slot] == h2) & (rows[:, 2] == meta)
                    & (rows[:, 4] == cp_pad[: wp.shape[0]]))
            assert bool((reached[true]).all()), f"length {l}: a true hit behind an empty slot"
            passed = table.tags[slot].to(torch.int64) == tag
            assert bool(passed[true].all()), f"length {l}: a true hit fails its tag"
            true_hits += int(true.sum())
            false_hits += int((reached & passed & ~true).sum())
            reached &= table.tags[slot] != 0
    return cps, true_hits, false_hits


@pytest.mark.parametrize("name", ["ascii", "multilingual", "astral", "unk_heavy", "punct_dense", "odd_n"])
def test_true_hits_pass_the_tag_filter(name):
    """No false negatives: every probe that truly matches a slot reaches it
    by a chain walk over the tags (no tag 0 before it) and passes its
    tag, astral text included."""
    cps, true_hits, _ = _tag_hits(name)
    assert true_hits > cps.shape[0] // 8


def test_tag_filter_meets_tag_collisions():
    """A tag is 8 bits: on these texts some tag hits are not true hits, so
    the kernel's confirmation against the rows has work to do."""
    assert sum(_tag_hits(name)[2] for name in texts()) > 0

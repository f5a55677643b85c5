"""The port's public surface (fast.encode / encode_text / encode_file /
decode / encode_external with resume, write_ids_file, the CLI, and the
same for the linear engine) against wordpiece_tpu's, on small inputs and
device="cpu".  Ids and files are compared exactly."""

import json

import numpy as np
import pytest
import torch

import wordpiece_tpu as wp
import wordpiece_tpu_torch as wpt
from wordpiece_tpu.cli import main as jax_main
from wordpiece_tpu_torch import api
from wordpiece_tpu_torch.bench.corpus import make_corpus, make_vocab
from wordpiece_tpu_torch.cli import main
from wordpiece_tpu_torch.core.vocab import parse_vocab

torch.set_num_threads(1)

CPU = dict(device="cpu")
VOCAB = ["[UNK]", "the", "quick", "brown", "fox", "jump", "##s", "over", "lazy", "dog",
         "ток", "##ени", "##за", "##ция", "中", "文", "-", "##case", "mixed", "case"]
TEXT = "the quick brown fox jumps over the lazy dog zz токенизация 中文 mixed-case "


@pytest.fixture
def files(tmp_path):
    tf = tmp_path / "corpus.txt"
    tf.write_text((TEXT * 40).strip())
    vf = tmp_path / "vocab.txt"
    vf.write_text("\n".join(VOCAB))
    return str(tf), str(vf), tmp_path


def test_encode_text_and_bytes():
    want = wp.fast.encode(TEXT, VOCAB)
    assert wpt.fast.encode(TEXT, VOCAB, **CPU) == want
    assert wpt.fast.encode_text(TEXT.encode(), VOCAB, **CPU) == want
    assert wpt.fast.encode("the dog", ["[UNK]", "the", "dog"], **CPU) == [1, 2]


def test_linear_encode_text_and_file(files):
    tf, vf, _ = files
    want = wp.fast.encode(TEXT, VOCAB)
    assert wpt.linear.encode(TEXT, VOCAB, **CPU) == want
    assert wpt.linear.encode_text(TEXT.encode(), VOCAB, **CPU) == want
    assert wpt.linear.encode_file(tf, vf, **CPU) == wp.fast.encode(tf, vf)
    assert wpt.linear.decode(VOCAB, [1, 6, 11]) == wp.linear.decode(VOCAB, [1, 6, 11])


def test_encode_file(files):
    tf, vf, _ = files
    want = wp.fast.encode(tf, vf)
    assert wpt.fast.encode(tf, vf, **CPU) == want
    assert wpt.fast.encode_file(tf, vf, **CPU) == want


def test_decode():
    ids = [1, 6, 11, -1, 99, 17, 3]
    assert wpt.fast.decode(VOCAB, ids) == wp.fast.decode(VOCAB, ids)
    assert wpt.fast.decode(VOCAB, [len(VOCAB)]) == []  # corrected off-by-one


def test_write_ids_file(tmp_path):
    a, b = tmp_path / "a.txt", tmp_path / "b.txt"
    wpt.write_ids_file(str(a), [1, 2, -1])
    wp.write_ids_file(str(b), [1, 2, -1])
    assert a.read_text() == b.read_text() == "1 2 -1 "


def test_encode_external_matches_jax(files):
    tf, vf, tmp = files
    mine, ref = tmp / "mine.txt", tmp / "ref.txt"
    wpt.fast.encode_external(tf, vf, str(mine), memory_limit=64, **CPU)
    wp.fast.encode_external(tf, vf, str(ref), memory_limit=64)
    assert mine.read_text() == ref.read_text()
    assert [int(x) for x in mine.read_text().split()] == wp.fast.encode(tf, vf)


def test_encode_external_checkpoint_resume(tmp_path):
    """Resume from a checkpoint after two batches (with garbage from a
    partial third batch) gives the uninterrupted output; a checkpoint from
    another vocabulary is refused."""
    data = make_corpus(400_000)
    lines = make_vocab(data, vocab_size=2000)
    tf, vf = tmp_path / "c.txt", tmp_path / "v.txt"
    tf.write_bytes(data)
    vf.write_text("\n".join(lines))
    ref = tmp_path / "ref.txt"
    wp.fast.encode_external(str(tf), str(vf), str(ref), 200_000)
    out = tmp_path / "out.txt"
    wpt.fast.encode_external(str(tf), str(vf), str(out), 200_000, **CPU)
    full = out.read_text()
    assert full == ref.read_text()
    assert not (tmp_path / "out.txt.state").exists()

    max_batch, begin = 200_000 // 2, 0
    for _ in range(2):
        batch = max_batch
        while batch < len(data) - begin and not data[begin + batch - 1 : begin + batch].isspace():
            batch += 1
        begin += batch
    prefix = "".join(f"{i} " for i in wpt.fast.encode_text(data[:begin], lines, **CPU))
    out.write_text(prefix + "999999 12345 ")
    vocab = parse_vocab(lines)
    state = {
        "text_size": len(data), "memory_limit": 200_000, "engine": "fast",
        "offset": begin, "out_bytes": len(prefix),
        "vocab_fp": api._vocab_fingerprint(vocab), "text_fp": api._file_fingerprint(str(tf)),
    }
    (tmp_path / "out.txt.state").write_text(json.dumps(state))
    wpt.fast.encode_external(str(tf), str(vf), str(out), 200_000, resume=True, **CPU)
    assert out.read_text() == full
    assert not (tmp_path / "out.txt.state").exists()

    out.write_text(prefix + "999999 ")
    state["vocab_fp"] ^= 1
    (tmp_path / "out.txt.state").write_text(json.dumps(state))
    wpt.fast.encode_external(str(tf), str(vf), str(out), 200_000, resume=True, **CPU)
    assert out.read_text() == full


def test_linear_encode_external_budget_and_resume(tmp_path, monkeypatch):
    """linear.encode_external batches at memory_limit // 20 (fast: // 2),
    records engine "linear" in its state file, resumes from a linear
    checkpoint and refuses a fast one."""
    data = make_corpus(200_000)
    lines = make_vocab(data, vocab_size=2000)
    tf, vf = tmp_path / "c.txt", tmp_path / "v.txt"
    tf.write_bytes(data)
    vf.write_text("\n".join(lines))
    ref = tmp_path / "ref.txt"
    wp.fast.encode_external(str(tf), str(vf), str(ref), 200_000)
    out = tmp_path / "out.txt"
    sizes, states = [], []
    encode_with = api._encode_with

    def recording(enc, raw):
        sizes.append(len(raw))
        if (tmp_path / "out.txt.state").exists():
            states.append(json.loads((tmp_path / "out.txt.state").read_text()))
        return encode_with(enc, raw)

    monkeypatch.setattr(api, "_encode_with", recording)
    wpt.linear.encode_external(str(tf), str(vf), str(out), 200_000, **CPU)
    monkeypatch.undo()
    full = out.read_text()
    assert full == ref.read_text()
    assert not (tmp_path / "out.txt.state").exists()
    assert sum(sizes) == len(data) and len(sizes) >= 19
    assert all(10_000 <= s < 10_100 for s in sizes[:-1])
    assert states and all(st["engine"] == "linear" for st in states)

    begin = sum(sizes[:3])
    prefix = "".join(f"{i} " for i in wpt.linear.encode_text(data[:begin], lines, **CPU))
    marker = "7" * (len(prefix) - 1) + " "  # tells a kept prefix from a rewrite
    vocab = parse_vocab(lines)
    state = {
        "text_size": len(data), "memory_limit": 200_000, "engine": "fast",
        "offset": begin, "out_bytes": len(prefix),
        "vocab_fp": api._vocab_fingerprint(vocab), "text_fp": api._file_fingerprint(str(tf)),
    }
    for engine, want in (("fast", full), ("linear", marker + full[len(prefix):])):
        out.write_text(marker + "999999 12345 ")
        (tmp_path / "out.txt.state").write_text(json.dumps(dict(state, engine=engine)))
        wpt.linear.encode_external(str(tf), str(vf), str(out), 200_000, resume=True, **CPU)
        assert out.read_text() == want, engine
        assert not (tmp_path / "out.txt.state").exists()


@pytest.mark.parametrize("mode", ["fast", "host", "oracle", "linear"])
def test_cli_encode_modes_match_jax(mode, files, capsys):
    tf, vf, tmp = files
    mine, ref = tmp / f"{mode}_mine.txt", tmp / f"{mode}_ref.txt"
    assert main([mode, tf, vf, "--out-file", str(mine), "--device", "cpu"]) == 0
    out_mine = capsys.readouterr().out
    jax_main([mode, tf, vf, "--out-file", str(ref)])
    out_ref = capsys.readouterr().out
    assert mine.read_bytes() == ref.read_bytes()
    assert out_mine == out_ref and "Total ids" in out_mine


def test_cli_fast_external_matches_jax(files):
    tf, vf, tmp = files
    mine, ref = tmp / "ext_mine.txt", tmp / "ext_ref.txt"
    main(["fast-external", tf, vf, "--out-file", str(mine), "--memory-limit-mb", "50",
          "--device", "cpu"])
    jax_main(["fast-external", tf, vf, "--out-file", str(ref), "--memory-limit-mb", "50"])
    assert mine.read_bytes() == ref.read_bytes()
    with pytest.raises(SystemExit):
        main(["fast-external", tf, vf, "--out-file", str(mine), "--memory-limit-mb", "10",
              "--device", "cpu"])


def test_cli_linear_external_matches_jax(files):
    tf, vf, tmp = files
    mine, ref = tmp / "lext_mine.txt", tmp / "lext_ref.txt"
    assert main(["linear-external", tf, vf, "--out-file", str(mine), "--memory-limit-mb", "50",
                 "--device", "cpu"]) == 0
    jax_main(["linear-external", tf, vf, "--out-file", str(ref), "--memory-limit-mb", "50"])
    assert mine.read_bytes() == ref.read_bytes()
    with pytest.raises(SystemExit):
        main(["linear-external", tf, vf, "--out-file", str(mine), "--device", "cpu"])


def test_cli_decode_matches_jax(files, capsys):
    tf, vf, _ = files
    main(["decode", tf, vf, "--ids", "1,6,11,99,17"])
    mine = capsys.readouterr()
    jax_main(["decode", tf, vf, "--ids", "1,6,11,99,17"])
    ref = capsys.readouterr()
    assert mine.out == ref.out and mine.err == ref.err


def test_encoder_cache_is_bounded_and_keyed_by_device():
    api._ENCODER_CACHE.clear()
    for k in range(api._ENCODER_CACHE_MAX + 3):
        wpt.fast.encode("a b", ["[UNK]", "a", "b", f"tok{k}"], **CPU)
    assert len(api._ENCODER_CACHE) <= api._ENCODER_CACHE_MAX
    assert all(key[2] == "cpu" for key in api._ENCODER_CACHE)


def test_make_encoder_engines():
    v = parse_vocab(["[UNK]", "a", "b", "ab"])
    cps = np.array([ord(c) for c in "ab a zz"], dtype=np.int32)
    host = api.make_encoder(v, "host", **CPU).encode_codepoints(cps)
    oracle = api.make_encoder(v, "oracle", **CPU).encode_codepoints(cps)
    fast = api.make_encoder(v, "fast", cache=True, **CPU).encode_bytes(b"ab a zz")
    linear = api.make_encoder(v, "linear", **CPU).encode_bytes(b"ab a zz")
    assert host.tolist() == oracle.tolist() == fast.tolist() == linear.tolist() == [3, 1, 0]
    with pytest.raises(ValueError):
        api.make_encoder(v, "host", cache=True)
    with pytest.raises(ValueError):
        api.make_encoder(v, "linear", cache=True, **CPU)
    with pytest.raises(ValueError):
        api.make_encoder(v, "nope")

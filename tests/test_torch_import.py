"""The port stands alone: it imports torch, never jax or wordpiece_tpu, and
its entry points refuse to run on a missing GPU instead of silently
falling back to the CPU."""

import ast
import glob
import importlib
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(
    glob.glob(os.path.join(ROOT, "wordpiece_tpu_torch", "**", "*.py"), recursive=True)
) + [os.path.join(ROOT, "chip_smoke.py")]


def test_import_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['wordpiece_tpu'] = None\n"
        "import wordpiece_tpu_torch\n"
        "import wordpiece_tpu_torch.cli, wordpiece_tpu_torch.engine_word\n"
        "import wordpiece_tpu_torch.engine_linear\n"
        "import wordpiece_tpu_torch.ops.word_kernel_cuda\n"
        "import wordpiece_tpu_torch.ops.commit, wordpiece_tpu_torch.ops.linear_match\n"
        "import wordpiece_tpu_torch.ops.linear_match_cuda, wordpiece_tpu_torch.bench.linear_cases\n"
        "import wordpiece_tpu_torch.ops.suffix_array, wordpiece_tpu_torch.ops.text_features\n"
        "import wordpiece_tpu_torch.utils.profiling\n"
        "import wordpiece_tpu_torch.engine, wordpiece_tpu_torch.ops.match_fast\n"
        "import wordpiece_tpu_torch.ops.match_fast_cuda, wordpiece_tpu_torch.ops.cuda_build\n"
        "import wordpiece_tpu_torch.parallel.sharding, wordpiece_tpu_torch.parallel.vocab_parallel\n"
        "import wordpiece_tpu_torch.parallel.word_sharding, wordpiece_tpu_torch.parallel.multihost\n"
        "import wordpiece_tpu_torch.dryrun, wordpiece_tpu_torch.bench.harness\n"
        "import chip_smoke\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'wordpiece_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def _imported_modules(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_jax_package_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "wordpiece_tpu"), f"{path} imports {mod}"


def _vocab():
    from wordpiece_tpu_torch.core.vocab import parse_vocab

    return parse_vocab(["[UNK]", "a", "b"])


def _entry_points(tmp_path):
    import wordpiece_tpu_torch as wpt
    from wordpiece_tpu_torch.cli import main
    from wordpiece_tpu_torch.engine_linear import LinearEncoder
    from wordpiece_tpu_torch.engine_word import WordEncoder

    tf = tmp_path / "c.txt"
    tf.write_text("a b")
    vf = tmp_path / "v.txt"
    vf.write_text("[UNK]\na\nb")
    return {
        "make_encoder": lambda: wpt.make_encoder(_vocab(), "fast"),
        "WordEncoder": lambda: WordEncoder(_vocab()),
        "fast.encode": lambda: wpt.fast.encode("a b", ["[UNK]", "a", "b"]),
        "fast.encode_external": lambda: wpt.fast.encode_external(
            str(tf), str(vf), str(tmp_path / "o.txt"), 1 << 20
        ),
        "cli": lambda: main(["fast", str(tf), str(vf)]),
        "make_encoder_linear": lambda: wpt.make_encoder(_vocab(), "linear"),
        "LinearEncoder": lambda: LinearEncoder(_vocab()),
        "linear.encode": lambda: wpt.linear.encode("a b", ["[UNK]", "a", "b"]),
        "linear.encode_external": lambda: wpt.linear.encode_external(
            str(tf), str(vf), str(tmp_path / "o.txt"), 1 << 20
        ),
        "cli_linear": lambda: main(["linear", str(tf), str(vf)]),
        "make_encoder_fast_stream": lambda: wpt.make_encoder(_vocab(), "fast-stream"),
        "cli_fast_stream": lambda: main(["fast-stream", str(tf), str(vf)]),
    }


@pytest.mark.parametrize(
    "name",
    ["make_encoder", "WordEncoder", "fast.encode", "fast.encode_external", "cli",
     "make_encoder_linear", "LinearEncoder", "linear.encode", "linear.encode_external",
     "cli_linear", "make_encoder_fast_stream", "cli_fast_stream"],
)
def test_entry_point_without_gpu_raises(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        _entry_points(tmp_path)[name]()


def test_entry_point_on_cpu_runs():
    import wordpiece_tpu_torch as wpt

    assert wpt.fast.encode("a b", ["[UNK]", "a", "b"], device="cpu") == [1, 2]
    enc = wpt.make_encoder(_vocab(), "fast", device="cpu")
    np.testing.assert_array_equal(enc.encode_bytes(b"b a zz"), [2, 1, 0])


def test_fast_stream_engine_encodes_on_cpu():
    import wordpiece_tpu_torch as wpt
    from wordpiece_tpu_torch.engine import FastEncoder

    enc = wpt.make_encoder(_vocab(), "fast-stream", device="cpu")
    assert isinstance(enc, FastEncoder) and enc.table.device.type == "cpu"
    np.testing.assert_array_equal(enc.encode_codepoints(np.array([98, 32, 97, 32, 122, 122])),
                                  [2, 1, 0])


def test_linear_engine_encodes_on_cpu():
    import wordpiece_tpu_torch as wpt

    enc = wpt.make_encoder(_vocab(), "linear", device="cpu")
    np.testing.assert_array_equal(enc.encode_bytes(b"b a zz"), [2, 1, 0])


def test_fast_without_native_runtime_raises(monkeypatch):
    """The JAX package falls back to its fast-stream engine here; the port
    raises instead of switching engines."""
    import wordpiece_tpu_torch as wpt
    from wordpiece_tpu_torch.runtime import loader

    monkeypatch.setattr(loader, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native host runtime"):
        wpt.make_encoder(_vocab(), "fast", device="cpu")


def test_linear_namespace_encodes():
    import wordpiece_tpu_torch as wpt
    from wordpiece_tpu_torch.core.oracle import encode_oracle_str

    text = "a b ab zz ba"
    want = encode_oracle_str(text.encode(), _vocab())
    assert wpt.linear.encode(text, ["[UNK]", "a", "b"], device="cpu") == want == [1, 2, 0, 0, 0]


@pytest.mark.parametrize("mode", ["linear", "linear-external"])
def test_cli_linear_modes_match_jax(mode, tmp_path, capsys):
    from wordpiece_tpu.cli import main as jax_main
    from wordpiece_tpu_torch.cli import main

    tf = tmp_path / "c.txt"
    tf.write_text("a b ab zz ba " * 20)
    vf = tmp_path / "v.txt"
    vf.write_text("[UNK]\na\nb\n##b")
    extra = ["--memory-limit-mb", "50"] if mode.endswith("-external") else []
    mine, ref = tmp_path / "mine.txt", tmp_path / "ref.txt"
    assert main([mode, str(tf), str(vf), "--out-file", str(mine), "--device", "cpu"] + extra) == 0
    out_mine = capsys.readouterr().out
    assert jax_main([mode, str(tf), str(vf), "--out-file", str(ref)] + extra) == 0
    assert capsys.readouterr().out == out_mine
    assert mine.read_bytes() == ref.read_bytes() and mine.read_text().startswith("1 2 1 3 ")


def test_cli_fast_stream_matches_jax(tmp_path, capsys):
    from wordpiece_tpu.cli import main as jax_main
    from wordpiece_tpu_torch.cli import main

    tf = tmp_path / "c.txt"
    tf.write_text("a b ab zz ba, 中 " * 20)
    vf = tmp_path / "v.txt"
    vf.write_text("[UNK]\na\nb\n##b\n,\n中")
    mine, ref = tmp_path / "mine.txt", tmp_path / "ref.txt"
    args = ["fast-stream", str(tf), str(vf)]
    assert main(args + ["--out-file", str(mine), "--device", "cpu"]) == 0
    out_mine = capsys.readouterr().out
    assert jax_main(args + ["--out-file", str(ref)]) == 0
    assert capsys.readouterr().out == out_mine
    assert mine.read_bytes() == ref.read_bytes() and mine.read_text().startswith("1 2 1 3 ")


# (module, function, the port's own extra parameters): the JAX package's
# module of the same name holds the counterpart.
SIGNATURES = [
    ("ops.commit", "commit", ()),
    ("ops.commit", "commit_with_positions", ()),
    ("engine", "encode_padded", ("combine",)),
    ("parallel.sharding", "encode_data_parallel", ()),
    ("parallel.sharding", "encode_2d_parallel", ()),
    ("engine_linear", "_linear_batch_core", ()),
    ("engine_linear", "_linear_batch_compact", ()),
]


@pytest.mark.parametrize("module,name,extra", SIGNATURES, ids=[s[1] for s in SIGNATURES])
def test_signature_matches_jax(module, name, extra):
    """The commit and its callers take their JAX counterparts' parameters:
    the commit exactly their names, the callers exactly their keyword
    statics (no bound on the walk), besides the port's own extras."""

    def params(package, kinds=None):
        fn = getattr(importlib.import_module(f"{package}.{module}"), name)
        return [p.name for p in inspect.signature(fn).parameters.values()
                if kinds is None or p.kind in kinds]

    if module == "ops.commit":
        assert params("wordpiece_tpu_torch") == params("wordpiece_tpu")
    kw = (inspect.Parameter.KEYWORD_ONLY, inspect.Parameter.VAR_KEYWORD)
    mine = [p for p in params("wordpiece_tpu_torch", kw) if p not in extra]
    assert mine == params("wordpiece_tpu", kw)

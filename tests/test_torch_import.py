"""The port stands alone: it imports torch, never jax or wordpiece_tpu, and
its entry points refuse to run on a missing GPU instead of silently
falling back to the CPU."""

import ast
import glob
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
        "import wordpiece_tpu_torch.ops.word_kernel_cuda\n"
        "import wordpiece_tpu_torch.utils.profiling\n"
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
    }


@pytest.mark.parametrize(
    "name", ["make_encoder", "WordEncoder", "fast.encode", "fast.encode_external", "cli"]
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


@pytest.mark.parametrize("engine", ["linear", "fast-stream"])
def test_not_ported_engines_raise(engine):
    import wordpiece_tpu_torch as wpt

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        wpt.make_encoder(_vocab(), engine, device="cpu")


def test_fast_without_native_runtime_raises(monkeypatch):
    """The JAX package falls back to its fast-stream engine here; the port
    raises instead of switching engines."""
    import wordpiece_tpu_torch as wpt
    from wordpiece_tpu_torch.runtime import loader

    monkeypatch.setattr(loader, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native host runtime"):
        wpt.make_encoder(_vocab(), "fast", device="cpu")


def test_linear_namespace_raises():
    import wordpiece_tpu_torch as wpt

    with pytest.raises(NotImplementedError, match="linear"):
        wpt.linear.encode("a b", ["[UNK]", "a", "b"])


@pytest.mark.parametrize("mode", ["linear", "linear-external", "fast-stream"])
def test_cli_not_ported_modes_exit_nonzero(mode, tmp_path):
    from wordpiece_tpu_torch.cli import main

    with pytest.raises(SystemExit) as exc:
        main([mode, str(tmp_path / "c.txt"), str(tmp_path / "v.txt")])
    assert exc.value.code not in (0, None)
    assert "not ported" in str(exc.value.code)

"""The port's cross-engine harness (wordpiece_tpu_torch.bench.harness) on
device="cpu" against the JAX package's (wordpiece_tpu.bench.harness): the
same corpora and vocabs through every engine, the collected id files byte
for byte, the table, and the failures the port reports where the JAX
harness prints "unavailable".  The CPU tokenizer adapters are stubbed to
return None in every test but the one that calls an adapter, so that
neither transformers nor tensorflow is imported."""

import os
import subprocess
import sys

import pytest
import torch

import wordpiece_tpu_torch.api as api
from wordpiece_tpu.bench import harness as jax_harness
from wordpiece_tpu_torch.bench import harness

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANGS = ["en", "ru", "ja", "zh"]
ENGINES = ["fast", "fast-stream", "linear", "host"]
ADAPTERS = ("_try_huggingface", "_try_transformers", "_try_tensorflow_text", "_try_torchtext",
            "_try_keras_nlp")
try_huggingface = harness._try_huggingface


def stub_adapters(mp):
    for module in (harness, jax_harness):
        for name in ADAPTERS:
            mp.setattr(module, name, lambda corpus, vocab_lines: None)


@pytest.fixture(autouse=True)
def _no_adapters(monkeypatch):
    stub_adapters(monkeypatch)


@pytest.fixture(scope="module")
def collected(tmp_path_factory):
    """Both harnesses at 0.02 MB a language, every engine, --collect, each
    in a directory of its own: {package: (directory, counts)}."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        stub_adapters(mp)
        for package, run, extra in (("jax", jax_harness.run, {}),
                                    ("torch", harness.run, {"device": "cpu"})):
            where = tmp_path_factory.mktemp(package)
            mp.chdir(where)
            _, counts = run(LANGS, 0.02, ENGINES, collect=True, iters=1, **extra)
            out[package] = (where, counts)
    return out


@pytest.mark.parametrize("lang", LANGS)
def test_collected_ids_equal_jax(collected, lang):
    (jax_dir, jax_counts), (dir_, counts) = collected["jax"], collected["torch"]
    streams = set()
    for engine in ENGINES:
        name = f"result_{engine}_{lang}.txt"
        mine = (dir_ / name).read_bytes()
        assert mine == (jax_dir / name).read_bytes(), name
        assert counts[f"{lang}/{engine}"] == jax_counts[f"{lang}/{engine}"]
        assert counts[f"{lang}/{engine}"] == len(mine.split())
        streams.add(mine)
    assert len(streams) == 1 and counts[f"{lang}/host"] > 0


def test_print_table_matches_jax(capsys):
    results = {
        "en": {"fast": 0.125, "host": 1.5, "linear": 0.25},
        "ru": {"fast": 0.5, "fast-stream": 0.75, "huggingface": 2.0},
        "zh": {},
    }
    jax_harness.print_table(results, 10.0)
    want = capsys.readouterr().out
    harness.print_table(results, 10.0, "cpu")
    head, rest = capsys.readouterr().out.split("\n", 1)
    assert head == "device: cpu"
    assert rest == want and "| fast | 0.12 (x1.0) | 0.50 (x1.0) | — |" in want


def test_engine_failure_fails_the_run(monkeypatch, tmp_path, capsys):
    real = api.make_encoder

    def failing(vocab, engine="fast", **kw):
        if engine == "linear":
            raise RuntimeError("linear: kernel failed to build")
        return real(vocab, engine=engine, **kw)

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(api, "make_encoder", failing)
    with pytest.raises(RuntimeError, match="failed to build"):
        harness.run(["en"], 0.002, ["host", "linear"], iters=1, device="cpu")
    assert "unavailable" not in capsys.readouterr().err
    monkeypatch.setattr(api, "make_encoder", real)
    with pytest.raises(ValueError, match="unknown engine"):
        harness.run(["en"], 0.002, ["host", "no-such-engine"], iters=1, device="cpu")


def test_main_without_gpu_raises(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        harness.main(["--langs", "en", "--corpus-size", "0.002", "--engines", "host"])


def test_huggingface_adapter_times():
    pytest.importorskip("tokenizers")
    corpus = b"the cat sat on the mat " * 50
    dt = try_huggingface(corpus, ["[UNK]", "the", "cat", "sat", "on", "mat", "##at"])
    assert isinstance(dt, float) and dt >= 0


def test_runs_with_jax_blocked(tmp_path):
    """The harness and everything its run imports stand without jax and
    the JAX package."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['wordpiece_tpu'] = None\n"
        "from wordpiece_tpu_torch.bench import harness\n"
        f"for name in {ADAPTERS!r}:\n"
        "    setattr(harness, name, lambda corpus, vocab_lines: None)\n"
        "res, counts = harness.run(['en'], 0.002, ['fast', 'fast-stream', 'linear', 'host'],\n"
        "                          iters=1, device='cpu')\n"
        "assert len(set(counts.values())) == 1, counts\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'wordpiece_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120, env=env)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"

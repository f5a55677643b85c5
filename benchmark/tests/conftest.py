"""The benchmark's own tests: CPU only, at small sizes, except those marked
`chip`, which need a CUDA device and skip without one.

    python -m pytest benchmark/tests -q          # from the checkout's root
"""

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA device; skipped without one")


@pytest.fixture
def chip():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def shrink(mix: dict) -> dict:
    """A mix at a size a CPU test can hold: the same law, a smaller pool."""
    mix = json.loads(json.dumps(mix))
    mix["corpus"].update(pool_bytes=300_000, vocab_sample_bytes=100_000, word_types=3000)
    docs = mix["documents"]
    if "bytes" in docs:
        docs["bytes"] = 40_000
    else:
        docs.update(max_bytes=20_000, sizes=64)
    mix.update(warmup_calls=min(mix["warmup_calls"], 3), check_calls=min(mix["check_calls"], 8),
               trace_calls=min(mix["trace_calls"], 2))
    return mix


# The article cells, measured and taken out for their spread (PERF.md §7),
# as a later PR would add them back: entries only, on the files there.
ARTICLE_CELLS = [
    {"name": f"{engine}.wiki-en-articles", "config": f"{engine}.bert-base-cased",
     "traffic": "wiki-en-articles", "chips": 1, "why": "one article a call"}
    for engine in ("fast", "linear")
]


@pytest.fixture
def small_root(tmp_path):
    """A copy of the benchmark's data (BENCHMARK.json, configs, traffic,
    metrics) with every mix shrunk and the article cells added: the
    harness runs from it unchanged."""
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        bench = json.load(f)
    bench["workloads"] += ARTICLE_CELLS
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(BENCH, d), tmp_path / "benchmark" / d)
    for f in (tmp_path / "benchmark" / "traffic").glob("*.json"):
        f.write_text(json.dumps(shrink(json.loads(f.read_text()))))
    return tmp_path

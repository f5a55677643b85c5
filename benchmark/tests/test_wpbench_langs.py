"""The ru, zh and ja mixes as a later PR would pair them with a
configuration: entries only, in a copy of the tree.  The fast-stream and
fast configurations run each mix on the program's CPU path, with the
mix's own vocab and with a multilingual one (`vocab_sample`), and come
out correct."""

import json
import time

import pytest

from wpbench import cell

MIXES = ["wiki-ru-10MB", "wiki-zh-10MB", "wiki-ja-10MB"]
MULTI = {"en": 0.4, "ru": 0.2, "zh": 0.2, "ja": 0.2}


@pytest.fixture
def lang_root(small_root):
    """small_root with a multilingual copy of each configuration and a cell
    for each configuration and mix."""
    bench = json.loads((small_root / "BENCHMARK.json").read_text())
    configs = {c["name"]: c for c in bench["configs"]}
    for engine in ("fast-stream", "fast"):
        base = configs[f"{engine}.bert-base-cased"]
        cfg = json.loads((small_root / base["file"]).read_text())
        multi = dict(cfg, name=f"{engine}.multilingual", vocab_sample=MULTI)
        (small_root / "benchmark" / "configs" / f"{engine}.multilingual.json").write_text(json.dumps(multi))
        bench["configs"].append(dict(base, name=f"{engine}.multilingual",
                                     file=f"benchmark/configs/{engine}.multilingual.json"))
        for config in (f"{engine}.bert-base-cased", f"{engine}.multilingual"):
            for mix in MIXES:
                bench["workloads"].append({"name": f"{config}.{mix}", "config": config, "traffic": mix,
                                           "chips": 1, "why": "a test"})
    (small_root / "BENCHMARK.json").write_text(json.dumps(bench))
    return small_root


@pytest.mark.parametrize("vocab", ["bert-base-cased", "multilingual"])
@pytest.mark.parametrize("engine", ["fast-stream", "fast"])
@pytest.mark.parametrize("mix", MIXES)
def test_a_new_mix_runs_correct_on_the_cpu(lang_root, mix, engine, vocab):
    c = cell.Cell(f"{engine}.{vocab}.{mix}", root=str(lang_root))
    assert c.mix["corpus"]["lang"] == mix.split("-")[1]
    assert ("vocab_sample" in c.config) == (vocab == "multilingual")
    res = cell.run(c, 2**31 + 33, 0.3, False, t_start=time.monotonic(), device="cpu")
    out = res["result"]
    assert res["error"] is None and out["correct"] is True and out["failed"] == 0
    assert res["info"]["calls_checked"] >= 1
    assert all(v["value"] == 0 for v in out["compared"].values())

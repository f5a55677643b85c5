"""A configuration, a traffic mix and a per-layer metric are added as new
files and new entries in BENCHMARK.json, with no edit to a file that is
there: here a throwaway fast-stream configuration (an engine with no
`encode_bytes`), a mix of short lines and a reader of one more stage."""

import json
import time

from wpbench import cell


def test_new_files_and_entries_make_a_new_cell(small_root):
    bench = json.loads((small_root / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (small_root / "benchmark").rglob("*") if p.is_file()}

    (small_root / "benchmark" / "configs" / "fast-stream.throwaway.json").write_text(json.dumps({
        "name": "fast-stream.throwaway", "engine": "fast-stream", "entry": "encode_codepoints",
        "vocab_size": 2000, "zero_counters": []}))
    (small_root / "benchmark" / "traffic" / "short-lines.json").write_text(json.dumps({
        "name": "short-lines",
        "corpus": {"lang": "en", "word_types": 500, "zipf_exponent": 1.2, "pool_bytes": 100_000,
                   "vocab_sample_bytes": 50_000},
        "documents": {"median_bytes": 80, "sigma": 0.5, "min_bytes": 20, "max_bytes": 400, "sizes": 32},
        "warmup_calls": 2, "check_calls": 5, "trace_calls": 2}))
    (small_root / "benchmark" / "metrics" / "host_join_us_per_call.py").write_text(
        "def read(records):\n"
        "    st = records['stages'].get('host_join')\n"
        "    return 1.0 if st is None else st['seconds'] * 1e6 / records['window']['calls']\n")
    bench["configs"].append({"name": "fast-stream.throwaway", "source": "https://example.org",
                             "file": "benchmark/configs/fast-stream.throwaway.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "fs.short", "config": "fast-stream.throwaway",
                               "traffic": "short-lines", "chips": 1, "why": "a test"})
    # the new cell brings an end-to-end metric of its own: the window's rate
    bench["end_to_end"].append({"name": "encode_MBps", "unit": "MB/s", "better": "higher", "bound": 0.25,
                                "source": "host_clock", "workloads": ["fs.short"]})
    bench["per_layer"].append({"name": "host_join_us_per_call", "unit": "us/call", "better": "lower",
                               "source": "program_span", "layer": "engine", "moves": "encode_MBps",
                               "workloads": ["fs.short"]})
    (small_root / "BENCHMARK.json").write_text(json.dumps(bench))

    c = cell.Cell("fs.short", root=str(small_root))
    plain = cell.run(c, 5, 0.3, False, t_start=time.monotonic(), device="cpu")["result"]
    assert plain["correct"] is True and set(plain["metrics"]) == {"encode_MBps", "setup_s"}
    traced = cell.run(c, 6, 0.3, True, t_start=time.monotonic(), device="cpu")["result"]
    assert traced["correct"] is True and "host_join_us_per_call" in traced["metrics"]
    assert all(p.read_bytes() == b for p, b in before.items())

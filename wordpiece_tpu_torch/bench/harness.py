"""Cross-engine benchmark harness: the port of wordpiece_tpu's bench/harness.py,
the counterpart of the reference's tests/speed_test.py.

    python -m wordpiece_tpu_torch.bench.harness [--langs en ru ja zh]
        [--corpus-size MB] [--engines fast fast-stream linear host]
        [--collect] [--iters N] [--device cuda|cpu]

Times each engine named in --engines (the word engine, fast-stream and
linear on --device, and the native host oracle), plus the CPU tokenizer
libraries that are importable, on identical corpus+vocab and prints a
benchmark.md-style GitHub-markdown table with x-multipliers against the
fastest, under a line that names the device the card engines ran on.
`--collect` writes each engine's ids to result_<engine>_<lang>.txt for
conformance diffing (speed_test.py:28-32).

--device defaults to cuda and raises without a GPU.  An engine named in
--engines that cannot be built, or whose kernel fails to build or launch,
fails the run: unlike the JAX harness, no engine is reported
"unavailable" and left out of the table.

No network: corpora are the deterministic synthetic sets from
bench/corpus.py, with make_vocab's vocab for each.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def time_engine(name: str, fn, iters: int = 3):
    best = None
    ids = None
    for _ in range(iters):
        t0 = time.perf_counter()
        ids = fn()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best, ids


def run(langs, size_mb, engines, collect=False, iters=3, device="cuda"):
    """Returns (results, counts): seconds by language and engine (the min
    of `iters` calls after one untimed warm-up), and the ids each
    "lang/engine" produced.  Every engine's encode returns host ids, so a
    timed call ends after the card's work and its copy back."""
    from ..api import make_encoder
    from ..core import unicode as uni
    from ..core.vocab import parse_vocab
    from ..engine_word import resolve_device
    from .corpus import make_corpus, make_vocab

    resolve_device(device)
    results: dict[str, dict[str, float]] = {}
    counts: dict[str, int] = {}
    for lang in langs:
        corpus = make_corpus(int(size_mb * 1e6), lang=lang)
        vocab_lines = make_vocab(corpus)
        vocab = parse_vocab(vocab_lines)
        cps = uni.decode_utf8(corpus).astype(np.int32)
        results[lang] = {}

        for engine in engines:
            # Raises for an unknown engine or one that cannot be built.
            enc = make_encoder(vocab, engine=engine, device=device)

            def call(enc=enc):
                if hasattr(enc, "encode_bytes"):
                    return enc.encode_bytes(corpus)
                return enc.encode_codepoints(cps)

            call()  # warm-up: the kernels' first use
            dt, ids = time_engine(engine, call, iters)
            results[lang][engine] = dt
            counts[f"{lang}/{engine}"] = len(ids)
            if collect:
                with open(f"result_{engine}_{lang}.txt", "w") as f:
                    f.write(" ".join(str(int(i)) for i in ids))

        # Competitor adapters (reference tests/speed_test.py:34-86), each
        # import-guarded: absent libraries print an explicit absence line
        # rather than silently skipping the row.  They are CPU libraries,
        # no part of the device path, so a failure in one is reported and
        # the run goes on.
        for name, adapter in (
            ("huggingface", _try_huggingface),
            ("transformers", _try_transformers),
            ("tensorflow-text", _try_tensorflow_text),
            ("torchtext", _try_torchtext),
            ("keras-nlp", _try_keras_nlp),
        ):
            try:
                dt = adapter(corpus, vocab_lines)
            except Exception as e:  # pragma: no cover - foreign-lib failure
                print(f"[{lang}] {name}: failed ({e})", file=sys.stderr)
                continue
            if dt is None:
                print(f"[{lang}] {name}: absent from environment", file=sys.stderr)
            else:
                results[lang][name] = dt

    return results, counts


def _try_huggingface(corpus: bytes, vocab_lines):
    """HuggingFace `tokenizers` WordPiece (speed_test.py:58-65 analogue)."""
    try:
        from tokenizers import Tokenizer
        from tokenizers.models import WordPiece as HFWordPiece
        from tokenizers.pre_tokenizers import Whitespace
    except ImportError:
        return None
    tok = Tokenizer(HFWordPiece({w: i for i, w in enumerate(vocab_lines)}, unk_token="[UNK]"))
    tok.pre_tokenizer = Whitespace()
    text = corpus.decode("utf-8", errors="ignore")
    t0 = time.perf_counter()
    tok.encode(text)
    return time.perf_counter() - t0


def _vocab_file(vocab_lines) -> str:
    import tempfile

    f = tempfile.NamedTemporaryFile(
        "w", suffix=".txt", delete=False, encoding="utf-8"
    )
    f.write("\n".join(vocab_lines))
    f.close()
    return f.name


def _try_transformers(corpus: bytes, vocab_lines):
    """transformers BertTokenizerFast, the torch ecosystem's tokenizer."""
    try:
        from transformers import BertTokenizerFast
    except ImportError:
        return None
    tok = BertTokenizerFast(
        _vocab_file(vocab_lines), do_lower_case=False, tokenize_chinese_chars=True
    )
    text = corpus.decode("utf-8", errors="ignore")
    t0 = time.perf_counter()
    tok(text, add_special_tokens=False)
    return time.perf_counter() - t0


def _try_tensorflow_text(corpus: bytes, vocab_lines):
    """tensorflow_text BertTokenizer (speed_test.py:35-56 analogue)."""
    try:
        import tensorflow as tf
        from tensorflow_text import BertTokenizer
    except ImportError:
        return None
    table = tf.lookup.StaticVocabularyTable(
        tf.lookup.KeyValueTensorInitializer(
            keys=list(vocab_lines),
            key_dtype=tf.string,
            values=tf.range(len(vocab_lines), dtype=tf.int64),
            value_dtype=tf.int64,
        ),
        num_oov_buckets=1,
    )
    tok = BertTokenizer(table, token_out_type=tf.int64, lower_case=False)
    text = corpus.decode("utf-8", errors="ignore")
    t0 = time.perf_counter()
    tok.tokenize(text)
    return time.perf_counter() - t0


def _try_torchtext(corpus: bytes, vocab_lines):
    """torchtext BERTTokenizer (speed_test.py:68-75 analogue)."""
    try:
        from torchtext.transforms import BERTTokenizer
    except ImportError:
        return None
    tok = BERTTokenizer(_vocab_file(vocab_lines), do_lower_case=False)
    text = corpus.decode("utf-8", errors="ignore")
    t0 = time.perf_counter()
    tok(text)
    return time.perf_counter() - t0


def _try_keras_nlp(corpus: bytes, vocab_lines):
    """keras_nlp WordPieceTokenizer (speed_test.py:78-86 analogue)."""
    try:
        import keras_nlp
    except ImportError:
        return None
    tok = keras_nlp.tokenizers.WordPieceTokenizer(
        vocabulary=list(vocab_lines), lowercase=False
    )
    text = corpus.decode("utf-8", errors="ignore")
    t0 = time.perf_counter()
    tok.tokenize(text)
    return time.perf_counter() - t0


def device_label(device) -> str:
    """The card's name for a cuda device, else "cpu"."""
    d = torch.device(device)
    return torch.cuda.get_device_name(d) if d.type == "cuda" else "cpu"


def print_table(results, size_mb, device="cuda"):
    """The JAX harness's table, under a line naming `device`, the device
    the fast, fast-stream and linear rows ran on."""
    engines = sorted({e for r in results.values() for e in r})
    langs = list(results)
    print(f"device: {device_label(device)}")
    print(f"\n### {size_mb} MB corpus, seconds (xN vs best)\n")
    print("| Algorithm | " + " | ".join(langs) + " |")
    print("|" + "---|" * (len(langs) + 1))
    best = {l: min(results[l].values()) for l in langs if results[l]}
    for e in engines:
        row = [e]
        for l in langs:
            if e in results[l]:
                v = results[l][e]
                mult = v / best[l] if best[l] > 0 else 0
                row.append(f"{v:.2f} (x{mult:.1f})")
            else:
                row.append("—")
        print("| " + " | ".join(row) + " |")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--langs", nargs="+", default=["en", "ru", "ja", "zh"])
    ap.add_argument("--corpus-size", type=float, default=10.0, help="MB")
    ap.add_argument(
        "--engines", nargs="+", default=["fast", "fast-stream", "linear", "host"]
    )
    ap.add_argument("--collect", action="store_true")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument(
        "--device",
        default="cuda",
        help="device of the fast, fast-stream and linear engines: cuda (default; fails "
        "without a GPU) or cpu",
    )
    args = ap.parse_args(argv)
    results, counts = run(
        args.langs, args.corpus_size, args.engines, args.collect, args.iters, args.device
    )
    print_table(results, args.corpus_size, args.device)
    for k, v in counts.items():
        print(f"ids {k}: {v}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

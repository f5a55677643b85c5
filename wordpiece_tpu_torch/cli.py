"""CLI runner — counterpart of the reference's tests/runner.cpp.

Usage:
  python -m wordpiece_tpu_torch <mode> <text_file> <vocab_file> [options]

Modes: fast and fast-external (the word engine on --device, "cuda" by
default), the host engines host and oracle, and decode.  The linear,
linear-external and fast-stream modes are not ported yet: they exit
non-zero with a message.
"""

from __future__ import annotations

import argparse
import sys
import time

_NOT_PORTED_MODES = {
    "linear": "linear",
    "linear-external": "linear",
    "fast-stream": "fast-stream",
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="wordpiece_tpu_torch")
    ap.add_argument("mode", choices=[
        "fast", "linear", "fast-stream", "host", "oracle",
        "fast-external", "linear-external", "decode",
    ])
    ap.add_argument("text_file")
    ap.add_argument("vocab_file")
    ap.add_argument("--out-file", default=None)
    ap.add_argument(
        "--memory-limit-mb",
        type=int,
        default=None,
        help="external modes: batch memory budget (floor 50MB, reference runner.cpp:28-33)",
    )
    ap.add_argument("--ids", default=None, help="decode mode: comma-separated ids")
    ap.add_argument(
        "--resume",
        action="store_true",
        help="external modes: continue from the last completed batch (out_file.state)",
    )
    ap.add_argument("--time", action="store_true", help="print wall time to stderr")
    ap.add_argument(
        "--device",
        default="cuda",
        help="device of the fast modes: cuda (default; fails without a GPU) or cpu",
    )
    ap.add_argument(
        "--n-threads",
        type=int,
        default=None,
        help="host threads for the native segment fan-out (reference: runner "
        "n_threads arg, tests/runner.cpp:23; default min(cpus,2), or the "
        "WORDPIECE_TPU_THREADS env var)",
    )
    args = ap.parse_args(argv)

    if args.mode in _NOT_PORTED_MODES:
        from .api import _NOT_PORTED

        raise SystemExit(f"mode {args.mode!r}: {_NOT_PORTED[_NOT_PORTED_MODES[args.mode]]}")

    from . import api
    from .core.vocab import read_vocab_file

    if args.n_threads is not None:
        from .runtime import loader

        loader.set_n_threads(args.n_threads)

    t0 = time.time()
    if args.mode == "decode":
        ids = [int(x) for x in (args.ids or "").split(",") if x.strip()]
        for tok in api.fast.decode(args.vocab_file, ids):
            print(tok)
        return 0

    if args.mode == "fast-external":
        if not args.out_file or args.memory_limit_mb is None:
            raise SystemExit("For external mode provide --out-file and --memory-limit-mb")
        if args.memory_limit_mb < 50:
            raise SystemExit("memory_limit cannot be less than 50Mb")
        api.fast.encode_external(
            args.text_file,
            args.vocab_file,
            args.out_file,
            args.memory_limit_mb * 1_000_000,
            resume=args.resume,
            device=args.device,
        )
        if args.time:
            print(f"time {time.time()-t0:.3f}s", file=sys.stderr)
        return 0

    vocab = read_vocab_file(args.vocab_file)
    enc = api.make_encoder(vocab, engine=args.mode, device=args.device)
    with open(args.text_file, "rb") as f:
        data = f.read()
    ids = api._encode_with(enc, data)
    print(f"Total ids {len(ids)}")
    if args.time:
        print(f"time {time.time()-t0:.3f}s", file=sys.stderr)
    if args.out_file:
        api.write_ids_file(args.out_file, ids)
    return 0


if __name__ == "__main__":
    sys.exit(main())

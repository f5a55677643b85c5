"""The control of `correct`: a run whose answers must come out wrong.

The plain reference is put in the program's place with its longest match
capped at CONTROL_LONGEST_MATCH codepoints, below the vocab's longest
token (16 here).  It breaks one guarantee the configurations state, that
every match is the longest piece of the vocab at its position: the step a
kernel that probes fewer lengths would take.  The run goes on as any run
of the cell (its traffic, window and check) and prints each seed's
readings as one JSON line; `correct` has to be false on every seed.

    python3 benchmark/control.py --workload <name> --seeds <n>[,<n>...] --seconds <s>

The benchmark's own runs never run it.  Run it on the chip, at the cell's
own sizes, with a window long enough to check as many calls as a run does.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from wpbench import cell  # noqa: E402
from wpbench.reference import Reference  # noqa: E402

CONTROL_LONGEST_MATCH = 8


class Control:
    """The capped reference, with the program's counters at 0."""

    def __init__(self, lines, counters):
        self.ref = Reference(lines, longest_match=CONTROL_LONGEST_MATCH)
        for name in counters:
            setattr(self, name, 0)

    def encode_bytes(self, doc: bytes):
        return self.ref.encode(doc)[0]

    def encode_codepoints(self, cps):
        return self.encode_bytes("".join(map(chr, cps)).encode("utf-8"))


def readings(c: cell.Cell, seed: int, seconds: float, device: str = "cuda") -> dict:
    res = cell.run(c, seed, seconds, False, t_start=time.monotonic(), device=device,
                   make=lambda lines: Control(lines, c.config["zero_counters"]))
    r = res["result"]
    return {"workload": c.name, "seed": seed, "correct": r["correct"],
            "calls": res["info"]["calls"], "calls_checked": res["info"]["calls_checked"],
            **{k: v["value"] for k, v in r["compared"].items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    c = cell.Cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(c, seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

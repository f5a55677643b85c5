"""The benchmark of wordpiece_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the CUDA devices the cell
asks for.  Prints the run's last line as one JSON object; see README.md.
"""

import time

T_START = time.monotonic()  # set-up is timed from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from wpbench import cell  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return cell.main(p.parse_args(argv), T_START)


if __name__ == "__main__":
    sys.exit(main())

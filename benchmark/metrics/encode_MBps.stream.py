"""`encode_MBps.fast`, read the same way: the traced run's window rate, per
layer in every cell (PERF.md §2)."""

import os

from wpbench.cell import reader_at

read = reader_at(os.path.join(os.path.dirname(os.path.abspath(__file__)), "encode_MBps.fast.py"))

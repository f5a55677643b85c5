"""`device_fetch_hop_us_per_call`, read the same way, in the cells where it moves
`device_memory_peak_MB` rather than `encode_MBps` (PERF.md §3)."""

import os

from wpbench.cell import reader_at

read = reader_at(os.path.join(os.path.dirname(os.path.abspath(__file__)), "device_fetch_hop_us_per_call.py"))

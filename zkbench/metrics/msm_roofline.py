"""The MSM kernels' share of their roofline, in percent: the least time of the
window's ``run_scan``, ``compact_add`` and ``horner`` launches over the device
time of their records (both kernels of ``run_scan``, ``compact_add``,
``horner``).

The program records each launch's least work (``utils/roofline.py``):
``run_scan`` reads its keys and writes its slots; ``compact_add`` reads and
writes a key and a point a slot, every slot a survivor, and its additions are
not priced, since which slots add is known only on the card (as
``roofline.lanes_bound_ms`` prices it); ``horner`` reads its window sums and
runs its chains, the longest chain's one-thread time as its floor. A launch's
least time is the larger of its bytes over the memory rate and its operations
over the integer rate, plus its floor."""

import re

from zkbench.harness import program_spans

LAYER = "KZG and MSMs"
MOVES = "prove_s"
KERNELS = re.compile(r"\b(run_scan_\w+|compact_add|horner)_kernel\b")
WORK = ("run_scan", "compact_add", "horner")

program_spans.enable()


def read(reading):
    return program_spans.kernel_share(reading, KERNELS, WORK)

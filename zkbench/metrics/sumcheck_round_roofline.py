"""The plain sumcheck's round kernels' share of their roofline, in percent: the
least time of the window's sumcheck rounds over the device time of their
kernels.

The program records a round's least work once a round
(``sumcheck/fused.py``, priced by ``utils/roofline.py``): round 0's
``halves_sums`` or a later round's ``fold_and_halves`` (the table read once,
the folded half written once, a product a folded entry, the column sums), and
the round's ``round_step`` (its rows and sponge state, its canonical products
and permutations); and the ``round_step`` chain as a floor, since each round
waits on the last one's challenge. A round's least time is the larger of its
bytes over the memory rate and its operations over the integer rate, plus the
floor. The device time is that of the window's ``halves_sums``,
``fold_and_halves`` and ``round_step`` records."""

import re

from zkbench.harness import program_spans

LAYER = "sumcheck round kernels"
MOVES = "prove_s"
KERNELS = re.compile(r"\b(halves_sums|fold_and_halves|round_step)_kernel\b")
WORK = ("sumcheck_round",)

program_spans.enable()


def read(reading):
    return program_spans.kernel_share(reading, KERNELS, WORK)

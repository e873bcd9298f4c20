"""The GKR phase kernels' share of their roofline, in percent: the least time
of the window's sumcheck phases over the device time of their kernels.

The program records a phase's least work once a phase, whatever launches run
it (``roofline.gkr_phase_cost``): the stack read once and each round's
coefficients and sponge state written once; each round's fused step and
transcript round, less the products on phase 1's table of ones; and each
round's one-warp transcript chain as a floor, since each round waits on the
last one's challenge. A phase's least time is the larger of its bytes over the
memory rate and its operations over the integer rate, plus the floor. The
device time is that of the ``gkr_big_round`` and ``gkr_phase_tail`` records
in the window."""

import re

from zkbench.harness import program_spans

LAYER = "GKR sumcheck provers"
MOVES = "prove_s"
KERNELS = re.compile(r"\b(gkr_big_round|gkr_phase_tail)_kernel\b")
WORK = ("gkr_phase",)

program_spans.enable()


def read(reading):
    return program_spans.kernel_share(reading, KERNELS, WORK)

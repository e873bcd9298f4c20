"""Multi-scalar multiplication strategies for BLS12-381 G1.

  * ``fixed_base``  -- comb method for k*G over a FIXED base (the trusted
    setup's Lagrange-SRS construction): a one-time (W, 2^c) table of d*2^(cw)*G turns
    every scalar multiplication into W table gathers + W-1 additions.
  * ``pippenger``   -- the general MSM: sorted buckets, a compaction tree, a
    suffix-scan bucket reduction and a Horner window combine; ``kernels`` holds
    the compaction round's and the window combine's CUDA kernels.
  * ``bit_split``   -- the general MSM as 255 bit-masked tree reductions with a
    width-1 Horner double chain; the independent check of ``pippenger``.

The batched double-and-add ladder lives in ``zktpu_torch.curve.device``.
"""

from .bit_split import msm_bitsplit
from .fixed_base import generator_comb_mul

__all__ = ["msm_bitsplit", "generator_comb_mul"]

"""Fixed-base comb: batched k*G for the construction of the trusted setup's SRS.

The counterpart of ``zktpu/msm/fixed_base.py``. The reference computes every
Lagrange-basis element as an independent G1 scalar multiplication of the
generator (kzg.rs:183-212). With a FIXED base the doubling work is shared once,
globally:

  one-time table  T[w][d] = d * 2^(c*w) * G   (W windows of c bits)
  per scalar      k*G = sum_w T[w][d_w(k)]    (W gathers + W-1 adds)

With c = 8 and 255-bit scalars: W = 32, an 8192-entry table, and 31 point
additions a lane instead of the ladder's ~510 double/add steps.

The table is built by doubling: rows 2d and 2d+1 come from row d by one
doubling and one addition of the window's base, so the 256 rows take 7 levels
of two launches each (the JAX package fills them with a 255-step scan of width
32, which is that compiler's cheap form and has no counterpart here).
"""

from __future__ import annotations

import torch

from ..curve import bls12_381 as hc
from ..curve import device as dc

COMB_C = 8
COMB_W = (dc.SCALAR_BITS + COMB_C - 1) // COMB_C  # 32

#: device -> flattened table (built once per device)
_tables: dict[torch.device, tuple] = {}


def _comb_table(device) -> tuple:
    """Triple of (W * 2^c, 12) tables, T[w * 2^c + d] = d * 2^(8w) * G.

    The window bases g_w = 2^(8w) * G come from a host double chain (255 cheap
    host doublings, one-time); the rows are built on the device."""
    device = dc.fq_ctx(device).device
    table = _tables.get(device)
    if table is not None:
        return table
    bases = []
    g = hc.G1_GEN
    for _ in range(COMB_W):
        bases.append(g)
        for _ in range(COMB_C):
            g = hc.double(g)
    g_vec = dc.pack_points(bases, device)  # (W, 12) triple

    # rows[k]: (rows so far, W, 12); row 0 is infinity, row 1 the bases
    level = tuple(t[None] for t in g_vec)  # rows [1, 2) as (1, W, 12)
    rows = [tuple(t[None] for t in dc.infinity_like((COMB_W,), device)), level]
    for _ in range(COMB_C - 1):
        even = dc.point_double(level)  # rows 2d
        base = tuple(t.expand_as(e).contiguous() for t, e in zip(g_vec, even))
        odd = dc.point_add(even, base)  # rows 2d + 1
        # interleave: (count, 2, W, 12) -> (2 * count, W, 12)
        level = tuple(
            torch.stack([e, o], dim=1).reshape(-1, COMB_W, e.shape[-1]) for e, o in zip(even, odd)
        )
        rows.append(level)
    full = tuple(torch.cat([r[i] for r in rows]) for i in range(3))  # (2^c, W, 12)
    table = tuple(
        t.transpose(0, 1).reshape(COMB_W * (1 << COMB_C), -1).contiguous() for t in full
    )
    _tables[device] = table
    return table


def generator_comb_mul(scalars):
    """scalars[i] * G1 for every lane: canonical (n, 8) Fr words -> a Jacobian
    triple of (n, 12) tables on the scalars' device. The drop-in replacement of
    ``curve.device.batch_generator_mul``."""
    table = _comb_table(scalars.device)
    acc = None
    for w in range(COMB_W):
        # 8-bit window w covers bits [8w, 8w + 8): word w // 4, offset 8 * (w % 4)
        d = (scalars[:, w // 4] >> (COMB_C * (w % 4))) & 0xFF
        pt = dc.gather_pt(table, d.long() + w * (1 << COMB_C))
        acc = pt if acc is None else dc.point_add(acc, pt)
    return acc

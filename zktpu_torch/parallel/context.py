"""Active-mesh context: one switch that turns the single-device protocol code
into its multi-device form.

The counterpart of ``zktpu/parallel/context.py``. ``use_mesh`` makes a mesh
(``parallel.mesh.Mesh``) visible to the hot paths -- the lazy-GKR layer
sumchecks (``gkr/protocol.py``) and the KZG commitment and quotient MSMs
(``pcs/kzg.py``) -- which then split their tables over the mesh's slots.
Field values, and so proof bytes, are unchanged: sharding is an execution
detail (tested byte-identical on an 8-slot CPU mesh).
"""

from __future__ import annotations

import contextlib

_ACTIVE: list = []

#: a sharded MSM must give each mesh slot at least this many rows to be worth
#: the copies between devices (zktpu's value; the GKR layers pass min_rows=1)
MIN_ROWS_PER_DEVICE = 256


def current_mesh():
    """The innermost mesh of ``use_mesh``, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def use_mesh(mesh):
    """Activate ``mesh`` for the enclosed protocol code (None = no-op)."""
    if mesh is None:
        yield
        return
    _ACTIVE.append(mesh)
    try:
        yield
    finally:
        _ACTIVE.pop()


def shardable(size: int, mesh, min_rows: int | None = None) -> bool:
    """True when a size-``size`` batch axis is worth sharding over ``mesh``:
    its slots divide it and each gets at least ``min_rows`` rows."""
    d = mesh.size
    if min_rows is None:
        min_rows = MIN_ROWS_PER_DEVICE
    return size % d == 0 and size // d >= min_rows

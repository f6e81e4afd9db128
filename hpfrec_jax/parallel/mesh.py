"""Device-mesh helpers.

The reference's only parallelism is shared-memory OpenMP over nonzeros
(``ncores``; ``cython_loops.pxi`` prange throughout).  The equivalent here
is SPMD data parallelism over a 1-D ``jax.sharding.Mesh`` whose axis
``'d'`` shards the blocked nonzero stream; factor tables are replicated
(they are small: 1M users x k=50 floats ~= 200 MB) and per-device segment
sums are combined with ``psum``.  GPUs of one host reach each other all to
all, so the mesh is 1-D and follows the algorithm alone.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
from jax.sharding import Mesh

DATA_AXIS = "d"


def make_mesh(devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """1-D data-parallel mesh over the given (default: all) devices."""
    if devices is None:
        devices = jax.devices()
    import numpy as np

    return Mesh(np.asarray(devices), (DATA_AXIS,))


_default_mesh: Optional[Mesh] = None


def default_mesh() -> Mesh:
    global _default_mesh
    if _default_mesh is None or len(_default_mesh.devices.ravel()) != len(jax.devices()):
        _default_mesh = make_mesh()
    return _default_mesh

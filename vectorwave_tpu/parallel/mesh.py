"""Device-mesh helpers.

The reference's parallel tier is thread pools + SIMD lanes
(``extensions/parallel/ParallelConfig.java``, ``StructuredExecutor.java``);
the equivalents here are mesh axes:

* ``data``   — batch sharding (the SoA-lane / batch fan-out analogue)
* ``signal`` — long-signal tiling with halo exchange (the output-range
  chunking / streaming-history analogue)

Meshes span the NVLink-joined cards of one host; several hosts come from
JAX's multi-controller runtime (see :mod:`.multihost`).
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh

from ..errors import ErrorCode, InvalidArgumentError


def make_mesh(
    shape: dict[str, int] | None = None,
    *,
    devices=None,
) -> Mesh:
    """Create a mesh from ``{axis: size}``.  With no shape, all devices go on
    a single ``data`` axis."""
    if devices is None:
        devices = jax.devices()
    if shape is None:
        shape = {"data": len(devices)}
    sizes = list(shape.values())
    total = int(np.prod(sizes))
    if total > len(devices):
        raise InvalidArgumentError(
            ErrorCode.DIST_BAD_MESH,
            f"Mesh shape {shape} needs {total} devices, have {len(devices)}",
            suggestions=("Reduce mesh axis sizes",),
        )
    grid = np.array(devices[:total]).reshape(sizes)
    return Mesh(grid, axis_names=tuple(shape.keys()))


def default_mesh() -> Mesh:
    """1-D data mesh over every visible device."""
    return make_mesh(None)

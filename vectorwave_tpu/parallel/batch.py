"""Batch (data-parallel) sharded transforms.

Counterpart of the reference's batch fan-out tier
(``extensions/modwt/BatchMODWT.java``, ``BatchSIMDMODWT`` SoA lanes,
``extensions/parallel/StructuredParallelTransform.java`` and
``ParallelWaveletDenoiser.java``): arrays are natively "SoA", so batch
parallelism is just a sharded leading axis — XLA runs each shard's transform
locally with ZERO communication (the MODWT is independent per signal), and
reductions (energies, statistics) ride the card links as ``psum``-style collectives
inserted automatically by the partitioner.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..transforms.multilevel import MultiLevelMODWTResult, modwt_multilevel


def shard_batch(x: jnp.ndarray, mesh: Mesh, *, axis: str = "data") -> jnp.ndarray:
    """Place ``x`` with its leading axis sharded over ``mesh[axis]``."""
    spec = P(axis, *([None] * (x.ndim - 1)))
    return jax.device_put(x, NamedSharding(mesh, spec))


def modwt_multilevel_sharded_batch(
    x: jnp.ndarray,
    wavelet,
    *,
    levels: int,
    mesh: Mesh,
    axis: str = "data",
    boundary: str = "periodic",
) -> MultiLevelMODWTResult:
    """Batch MODWT with the batch axis sharded over the mesh.

    Equivalent to ``BatchMODWT.multiLevelAoS`` running one SIMD lane per
    signal — here one mesh shard per sub-batch.  The computation is jitted
    with explicit output shardings so results stay distributed.
    """
    x = shard_batch(x, mesh, axis=axis)

    @jax.jit
    def run(x):
        return modwt_multilevel(x, wavelet, levels=levels, boundary=boundary)

    return run(x)

"""Multi-host meshes and the hierarchical transform facade.

The reference is single-process: its widest "distribution" is a thread pool
(``extensions/parallel/ParallelConfig.java``).  Here the cards of one host
are joined all to all by NVLink, and hosts are joined by a network that is
an order of magnitude slower and shared.  The layout rule that follows: axes
whose collectives run *per transform* (the signal-tiling halo ``ppermute``)
must stay inside a host, and the axis crossing hosts must carry only work
that needs **zero intra-transform communication** — the batch axis.  This
module encodes that rule:

* ``make_multihost_mesh`` builds a ``("host", "chip")`` mesh whose host axis
  follows the real process boundaries (``device.process_index``), so any
  collective over ``"chip"`` is guaranteed to stay inside a host.
* ``modwt_multilevel_multihost`` / ``imodwt_multilevel_multihost`` shard the
  batch over ``"host"`` (zero bytes between hosts during the transform) and
  tile the signal over ``"chip"`` (one cumulative halo exchange), composing
  the tiled engine (:mod:`.tiled`) with batch sharding.
* ``communication_report`` is the analytic communication model: exact bytes
  moved per axis per transform.

On one host (one process, up to four cards, or the virtual CPU devices of
the tests) use :func:`..mesh.make_mesh` with the axes the algorithm needs;
this module matters only once several processes are attached.  On a
single-process validation mesh the host axis is a contiguous split — the
sharding program is identical, only the physical link differs.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..errors import ErrorCode, InvalidArgumentError
from ..transforms.modwt import _resolve_discrete
from ..transforms.multilevel import MultiLevelMODWTResult
from .tiled import imodwt_multilevel_tiled, modwt_multilevel_tiled

HOST_AXIS = "host"
CHIP_AXIS = "chip"


def make_multihost_mesh(
    n_hosts: int | None = None,
    chips_per_host: int | None = None,
    *,
    devices=None,
) -> Mesh:
    """Build a ``("host", "chip")`` mesh aligned with process boundaries.

    In a real multi-controller run the grid rows are grouped by
    ``device.process_index`` so the ``"chip"`` axis never leaves a host.  On
    a single process (tests, virtual CPU meshes) pass ``n_hosts`` explicitly
    and the device list is split contiguously into simulated hosts.
    """
    if devices is None:
        devices = jax.devices()
    by_process: dict[int, list] = {}
    for d in devices:
        by_process.setdefault(getattr(d, "process_index", 0), []).append(d)
    if len(by_process) > 1:
        # Real multi-host: one mesh row per process.
        counts = {len(v) for v in by_process.values()}
        if len(counts) != 1:
            raise InvalidArgumentError(
                ErrorCode.DIST_BAD_MESH,
                f"Uneven devices per process: { {k: len(v) for k, v in by_process.items()} }",
                suggestions=("Pass an explicit, balanced device list",),
            )
        rows = [by_process[p] for p in sorted(by_process)]
        if n_hosts is not None and n_hosts != len(rows):
            raise InvalidArgumentError(
                ErrorCode.DIST_BAD_MESH,
                f"n_hosts={n_hosts} but {len(rows)} processes are attached",
                suggestions=("Omit n_hosts to use the process count",),
            )
        grid = np.array(rows)
    else:
        if n_hosts is None:
            n_hosts = 1
        if chips_per_host is None:
            chips_per_host = len(devices) // n_hosts
        need = n_hosts * chips_per_host
        if need > len(devices) or chips_per_host < 1:
            raise InvalidArgumentError(
                ErrorCode.DIST_BAD_MESH,
                f"Mesh {n_hosts}x{chips_per_host} needs {need} devices, "
                f"have {len(devices)}",
                suggestions=("Reduce n_hosts or chips_per_host",),
            )
        grid = np.array(devices[:need]).reshape(n_hosts, chips_per_host)
    return Mesh(grid, axis_names=(HOST_AXIS, CHIP_AXIS))


def _mesh_process_count(mesh: Mesh) -> int:
    return len({getattr(d, "process_index", 0) for d in mesh.devices.flat})


def _place(x, mesh: Mesh):
    """Shard [batch, N] with batch over hosts and the signal over chips.

    Single controller: ``x`` is the full global block.  Multi-controller
    (one process per mesh host row): each process passes its LOCAL batch
    rows — the standard JAX convention — and the global array is assembled
    from per-process data (an already-correctly-sharded ``jax.Array`` passes
    through untouched).
    """
    sharding = NamedSharding(mesh, P(HOST_AXIS, CHIP_AXIS))
    if not hasattr(x, "ndim"):
        x = np.asarray(x)
    if x.ndim != 2:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"multihost facade expects [batch, n], got shape {x.shape}",
            suggestions=("Reshape leading axes into one batch axis",),
        )
    if isinstance(x, jax.core.Tracer):
        if _mesh_process_count(mesh) > 1:
            # the multi-controller convention is process-LOCAL rows
            # assembled via make_array_from_process_local_data, which a
            # traced value cannot express — sharding the local block as
            # if it were global would silently diverge per process
            raise InvalidArgumentError(
                ErrorCode.CFG_INVALID_CONFIG,
                "multihost facades cannot be traced (jit) in "
                "multi-controller runs: pass concrete per-process rows",
                suggestions=("Call the facade outside jit, or build the "
                             "global array first",),
            )
        # single-controller jit trace: tracers carry no committed
        # sharding, and device_put/make_array are invalid — annotate the
        # layout instead and let the partitioner place it (querying
        # .sharding on tracers raises on jax >= 0.9)
        return jax.lax.with_sharding_constraint(x, sharding)
    if isinstance(x, jax.Array) and x.sharding.is_equivalent_to(sharding, x.ndim):
        return x
    n_hosts = mesh.shape[HOST_AXIS]
    if _mesh_process_count(mesh) > 1:
        # x = this process's rows; the global batch stacks one block per host
        x = np.asarray(x)
        return jax.make_array_from_process_local_data(
            sharding, x, (x.shape[0] * n_hosts, x.shape[1])
        )
    x = jnp.asarray(x)
    if x.shape[0] % n_hosts != 0:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"batch {x.shape[0]} not divisible by {n_hosts} hosts",
            suggestions=("Pad the batch to a multiple of the host count",),
        )
    return jax.device_put(x, sharding)


def modwt_multilevel_multihost(
    x,
    wavelet,
    *,
    levels: int,
    mesh: Mesh,
    boundary: str = "periodic",
    backend: str = "auto",
) -> MultiLevelMODWTResult:
    """Multi-level MODWT of a [batch, N] block over a 2-host-axis mesh.

    Batch shards over ``"host"`` (no traffic between hosts during the
    transform); the signal tiles over ``"chip"`` with halo exchange.
    Machine-precision parity with the single-device transform for every
    boundary mode (op order inside the compiled program may differ) — the
    distributed analogue of ``BatchMODWT.multiLevelAoS`` run across
    machines (``extensions/modwt/BatchMODWT.java:34-151``).
    """
    x = _place(x, mesh)
    return modwt_multilevel_tiled(
        x,
        wavelet,
        levels=levels,
        mesh=mesh,
        axis=CHIP_AXIS,
        boundary=boundary,
        batch_axis=HOST_AXIS,
        backend=backend,
    )


def imodwt_multilevel_multihost(
    result: MultiLevelMODWTResult,
    wavelet,
    *,
    mesh: Mesh,
    boundary: str = "periodic",
    backend: str = "auto",
) -> jnp.ndarray:
    """Inverse of :func:`modwt_multilevel_multihost`."""
    return imodwt_multilevel_tiled(
        result,
        wavelet,
        mesh=mesh,
        axis=CHIP_AXIS,
        boundary=boundary,
        batch_axis=HOST_AXIS,
        backend=backend,
    )


class CommunicationReport(NamedTuple):
    """Analytic per-transform communication volume for the multihost layout."""

    halo_bytes_per_chip: int  # halo ppermute traffic received per chip
    host_bytes_per_host: int  # 0 by construction during the transform
    per_level_halo_samples: tuple[int, ...]
    halo_fraction_of_compute_bytes: float  # comm / local HBM traffic


def communication_report(
    mesh: Mesh,
    wavelet,
    *,
    levels: int,
    n: int,
    batch: int,
    dtype_bytes: int = 4,
    direction: str = "forward",
) -> CommunicationReport:
    """Exact bytes each chip receives per transform under the multihost
    layout.

    Forward analysis gathers a LEFT halo of ``(L0-1)*2^(j-1)`` samples per
    level (``tiled.py`` docstring); the symmetric inverse needs two-sided
    halos, counted as 2x.  The batch-over-host axis exchanges nothing — that
    is the point of the layout.  Periodic/zero analysis sends the same total
    (``sum_j (L0-1) 2^(j-1) = (L0-1)(2^J - 1)``) as one cumulative message.

    Scope: exact for PERIODIC/ZERO (and the symmetric inverse's two-sided
    halos via ``direction="inverse_symmetric"``); the symmetric DEEP-halo
    regime (halo wider than a shard) falls back to an all_gather whose
    traffic this model does not count.
    """
    w = _resolve_discrete(wavelet)
    l0 = len(w.dec_lo)
    chips = mesh.shape[CHIP_AXIS]
    hosts = mesh.shape[HOST_AXIS]
    if batch % hosts != 0:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"batch {batch} not divisible by {hosts} hosts (the transform "
            f"itself rejects such a batch)",
            suggestions=("Pad the batch to a multiple of the host count",),
        )
    local_batch = batch // hosts
    halos = tuple((l0 - 1) * 2 ** (j - 1) for j in range(1, levels + 1))
    sides = 2 if direction == "inverse_symmetric" else 1
    halo = sum(halos) * sides * local_batch * dtype_bytes if chips > 1 else 0
    # local HBM traffic for the same work: read x once + write levels+1 planes
    local_n = n // chips
    compute_bytes = local_batch * local_n * (levels + 2) * dtype_bytes
    frac = halo / compute_bytes if compute_bytes else math.inf
    return CommunicationReport(int(halo), 0, halos, float(frac))

"""2-D MODWT tiled across chips along the ROW (H) axis with halo exchange.

The 2-D analogue of :mod:`.tiled`: an image batch is sharded along H over a
mesh axis; the W axis stays whole per shard, so the W pass is purely local
and only the H pass needs neighbor data.  Because the H pass reads backward
(analysis) / forward (synthesis) at most the cumulative composite span
``(L0-1)(2^J - 1)`` rows away, ONE slab exchange per transform suffices:

* analysis: fetch ``span`` rows from the upper ring neighbor
  (``jax.lax.ppermute``), run the whole local cascade on
  ``[halo | shard]`` with the GLOBAL boundary along W and ZERO along H
  (the halo supplies the true rows; beyond it zero is either exactly the
  global zero extension or cropped), then crop each level to shard rows.
* synthesis: the adjoint — ``span`` rows from the lower neighbor appended
  below, cascade, crop to the leading shard rows.

PERIODIC keeps the ring wrap link (global circular parity is exact); ZERO
drops it — ``ppermute`` zero-fills missing sources, which IS the zero
extension.  SYMMETRIC mirrors the global image head/foot, which spans
shards at depth; it takes an ``all_gather`` of the H axis + the exact
local op + a row slice (the H extent of images is modest next to 1-D
signal lengths, so the gather is cheap relative to the cascade).

Machine-precision parity with the single-device transforms is guarded by
``tests/test_tiled2d.py`` on the virtual 8-device CPU mesh.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..errors import ErrorCode, InvalidArgumentError
from ..ops.convolve import atrous_analysis_pair
from ..transforms.modwt import _resolve_discrete
from ..transforms.twodim import MultiLevelMODWT2Result, _check_2d, _inv_axis
from ..transforms.multilevel import _check_level_fits
from .tiled import _cached_program, _gather_halo, _ring_perms, _wavelet_key

_INV_SQRT2 = 1.0 / math.sqrt(2.0)

__all__ = ["modwt2_multilevel_tiled", "imodwt2_multilevel_tiled"]


def _rows_spec(ndim: int, axis: str, batch_axis: str | None) -> P:
    """PartitionSpec tiling axis -2 (H); optionally batch over the first."""
    if ndim < 2:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            "tiled 2-D transforms need [..., H, W] inputs",
        )
    if batch_axis is None:
        return P(*([None] * (ndim - 2)), axis, None)
    if ndim < 3:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            "batch_axis sharding needs a leading batch dimension",
            suggestions=("Add a batch axis or drop batch_axis",),
        )
    return P(batch_axis, *([None] * (ndim - 3)), axis, None)


def _gather_rows_halo(local, halo_len, axis, perm, side):
    """:func:`.tiled._gather_halo` along axis -2 (rows)."""
    lt = jnp.swapaxes(local, -1, -2)
    h = _gather_halo(lt, halo_len, axis, perm, side)
    return jnp.swapaxes(h, -1, -2)


def _h_pair_zero(x, low, high, spacing):
    """Analysis pair along H with zero boundary (slab-local)."""
    xt = jnp.swapaxes(x, -1, -2)
    a, d = atrous_analysis_pair(xt, low, high, spacing=spacing,
                                boundary="zero")
    return jnp.swapaxes(a, -1, -2), jnp.swapaxes(d, -1, -2)


def _validate(x_h, size, name):
    if x_h % size != 0:
        raise InvalidArgumentError(
            ErrorCode.DIST_TILE_TOO_SMALL,
            f"{name}: H={x_h} must divide evenly across {size} shards",
            suggestions=("Pad the image rows to a multiple of the mesh axis "
                         "size",),
        )


def modwt2_multilevel_tiled(
    x: jnp.ndarray,
    wavelet,
    *,
    levels: int,
    mesh: Mesh,
    axis: str = "rows",
    boundary: str = "periodic",
    batch_axis: str | None = None,
) -> MultiLevelMODWT2Result:
    """J-level 2-D MODWT of images sharded along H (axis -2).

    Matches the single-device :func:`..transforms.twodim.modwt2_multilevel`
    to machine precision for periodic/zero/symmetric; communication is one
    ``span``-row slab ``ppermute`` per transform (symmetric: one
    ``all_gather`` of H — see module docstring).
    """
    _check_2d(x, "modwt2_multilevel_tiled")
    w = _resolve_discrete(wavelet)
    boundary_l = boundary.lower()
    size = mesh.shape[axis]
    h = x.shape[-2]
    _validate(h, size, "modwt2_multilevel_tiled")
    _check_level_fits(w, levels, min(h, x.shape[-1]))
    low = w.dec_lo * _INV_SQRT2
    high = w.dec_hi * _INV_SQRT2
    # cumulative composite span: every level's backward reach summed
    span = (w.filter_length - 1) * ((1 << levels) - 1)
    wrap = boundary_l.startswith("per")
    from_left, _ = _ring_perms(axis, mesh, wrap)
    w_boundary = "periodic" if wrap else "zero"

    # symmetric mirrors span shards; periodic with span >= H would need the
    # extension to wrap MORE than once, which the zero-filled slab cannot
    # express — both take the exact gather path
    if boundary_l.startswith("sym") or (wrap and span >= h):
        def shard_fn(x_local):
            from ..transforms.twodim import modwt2_multilevel

            idx = jax.lax.axis_index(axis)
            n_loc = x_local.shape[-2]
            full = jax.lax.all_gather(x_local, axis, axis=-2, tiled=True)
            res = modwt2_multilevel(full, w, levels=levels,
                                    boundary=boundary_l)
            start = idx * n_loc

            def sl(v):
                return jax.lax.dynamic_slice_in_dim(v, start, n_loc, axis=-2)

            dets = tuple(tuple(sl(p) for p in trip) for trip in res.details)
            return dets, sl(res.approx)
    else:
        def shard_fn(x_local):
            n_loc = x_local.shape[-2]
            halo = _gather_rows_halo(x_local, min(span, n_loc * size), axis,
                                     from_left, "left")
            cur = jnp.concatenate([halo, x_local], axis=-2)
            dets = []
            for level in range(1, levels + 1):
                spacing = 1 << (level - 1)
                a_w, d_w = atrous_analysis_pair(
                    cur, low, high, spacing=spacing, boundary=w_boundary
                )
                ll, hl = _h_pair_zero(a_w, low, high, spacing)
                lh, hh = _h_pair_zero(d_w, low, high, spacing)
                dets.append((lh[..., -n_loc:, :], hl[..., -n_loc:, :],
                             hh[..., -n_loc:, :]))
                cur = ll
            return tuple(dets), cur[..., -n_loc:, :]

    spec = _rows_spec(x.ndim, axis, batch_axis)
    fn = _cached_program(
        ("fwd2d", _wavelet_key(w), levels, mesh, axis, boundary_l,
         batch_axis, x.ndim),
        lambda: jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(spec,),
            out_specs=(
                tuple((spec, spec, spec) for _ in range(levels)), spec
            ),
            check_vma=False,
        ),
    )
    x = jax.device_put(x, NamedSharding(mesh, spec))
    details, approx = fn(x)
    return MultiLevelMODWT2Result(tuple(details), approx)


def imodwt2_multilevel_tiled(
    result: MultiLevelMODWT2Result,
    wavelet,
    *,
    mesh: Mesh,
    axis: str = "rows",
    boundary: str = "periodic",
    batch_axis: str | None = None,
) -> jnp.ndarray:
    """Inverse of :func:`modwt2_multilevel_tiled` (synthesis reads forward:
    the slab comes from the LOWER ring neighbor and is appended below)."""
    w = _resolve_discrete(wavelet)
    boundary_l = boundary.lower()
    levels = result.levels
    size = mesh.shape[axis]
    h = result.approx.shape[-2]
    _validate(h, size, "imodwt2_multilevel_tiled")
    low = w.rec_lo * _INV_SQRT2
    high = w.rec_hi * _INV_SQRT2
    span = (w.filter_length - 1) * ((1 << levels) - 1)
    wrap = boundary_l.startswith("per")
    _, from_right = _ring_perms(axis, mesh, wrap)
    w_boundary = "periodic" if wrap else "zero"

    if boundary_l.startswith("sym") or (wrap and span >= h):
        # see the analysis gather-path note on multi-wrap periodic spans
        def shard_fn(details, approx):
            from ..transforms.twodim import imodwt2_multilevel

            idx = jax.lax.axis_index(axis)
            n_loc = approx.shape[-2]

            def ag(v):
                return jax.lax.all_gather(v, axis, axis=-2, tiled=True)

            full = imodwt2_multilevel(
                MultiLevelMODWT2Result(
                    tuple(tuple(ag(p) for p in trip) for trip in details),
                    ag(approx),
                ),
                w, boundary=boundary_l,
            )
            return jax.lax.dynamic_slice_in_dim(
                full, idx * n_loc, n_loc, axis=-2
            )
    else:
        def shard_fn(details, approx):
            n_loc = approx.shape[-2]
            eff = min(span, n_loc * size)

            def ext(v):
                halo = _gather_rows_halo(v, eff, axis, from_right, "right")
                return jnp.concatenate([v, halo], axis=-2)

            cur = ext(approx)
            dets = tuple(
                tuple(ext(p) for p in trip) for trip in details
            )
            for level in range(levels, 0, -1):
                lh, hl, hh = dets[level - 1]
                spacing = 1 << (level - 1)

                def inv_h(a, d):
                    at = jnp.swapaxes(a, -1, -2)
                    dt = jnp.swapaxes(d, -1, -2)
                    return jnp.swapaxes(
                        _inv_axis(at, dt, low, high, spacing, "zero", w,
                                  level),
                        -1, -2,
                    )

                col_a = inv_h(cur, hl)
                col_d = inv_h(lh, hh)
                cur = _inv_axis(col_a, col_d, low, high, spacing,
                                w_boundary, w, level)
            return cur[..., :n_loc, :]

    spec = _rows_spec(result.approx.ndim, axis, batch_axis)
    fn = _cached_program(
        ("inv2d", _wavelet_key(w), levels, mesh, axis, boundary_l,
         batch_axis, result.approx.ndim),
        lambda: jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(
                tuple((spec, spec, spec) for _ in range(levels)), spec
            ),
            out_specs=spec,
            check_vma=False,  # see the analysis shard_map note
        ),
    )
    put = lambda v: jax.device_put(v, NamedSharding(mesh, spec))  # noqa: E731
    details = tuple(tuple(put(p) for p in trip) for trip in result.details)
    return fn(details, put(result.approx))

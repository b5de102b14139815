"""2-D wavelet transforms (separable), beyond the reference's scope.

The reference is 1-D only; 2-D is a natural extension because the
separable construction is exactly two batched 1-D passes — the row pass
vectorizes over columns and vice versa, each a batched convolution.  Conventions follow the 1-D engine: undecimated
MODWT2 with per-stage 1/sqrt(2) scaling and the same three boundary modes;
decimated DWT2 with the `ops.dwt` indexing.

Subband convention (first letter = filter along H/rows, second = along
W/columns): ``ll`` low/low (smooth), ``lh`` low-H + high-W (responds to
VERTICAL edges — variation along W), ``hl`` high-H + low-W (horizontal
edges), ``hh`` high/high (diagonal).  Arrays are ``[..., H, W]``; leading
axes are batch.  Like the 1-D engine, only PERIODIC round trips are exact
to machine precision end-to-end; zero/symmetric are interior-exact with
edge effects within the filter support.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax.numpy as jnp

from ..errors import ErrorCode, InvalidArgumentError, InvalidSignalError
from ..ops.convolve import atrous_analysis_pair, atrous_convolve
from ..ops.dwt import dwt, idwt
from .modwt import MODWTResult, _resolve_discrete, imodwt, modwt
from .multilevel import _check_level_fits, _symmetric_alignment, _tau_j

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


def _check_2d(x: jnp.ndarray, name: str) -> None:
    if x.ndim < 2:
        raise InvalidSignalError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"{name} needs [..., H, W] input, got shape {tuple(x.shape)}",
        )


class MODWT2Result(NamedTuple):
    """Single-level 2-D MODWT subbands, each shaped like the input."""

    ll: jnp.ndarray
    lh: jnp.ndarray
    hl: jnp.ndarray
    hh: jnp.ndarray

    def energy(self) -> jnp.ndarray:
        return sum((b**2).sum(axis=(-1, -2)) for b in self)


def modwt2(x: jnp.ndarray, wavelet, *, boundary: str = "periodic") -> MODWT2Result:
    """Single-level separable 2-D MODWT: columns pass then rows pass."""
    _check_2d(x, "modwt2")
    w = _resolve_discrete(wavelet)
    col = modwt(x, w, boundary=boundary)          # along W
    a = _rows_pair(col.approx, w, boundary)       # along H: (low-H, high-H)
    d = _rows_pair(col.detail, w, boundary)
    return MODWT2Result(ll=a[0], lh=d[0], hl=a[1], hh=d[1])


def _rows_pair(x: jnp.ndarray, w, boundary: str):
    xt = jnp.swapaxes(x, -1, -2)
    res = modwt(xt, w, boundary=boundary)
    return (
        jnp.swapaxes(res.approx, -1, -2),
        jnp.swapaxes(res.detail, -1, -2),
    )


def imodwt2(result: MODWT2Result, wavelet, *, boundary: str = "periodic") -> jnp.ndarray:
    """Inverse separable 2-D MODWT (rows pass inverse, then columns)."""
    w = _resolve_discrete(wavelet)

    def inv_rows(a, d):
        at = jnp.swapaxes(a, -1, -2)
        dt = jnp.swapaxes(d, -1, -2)
        return jnp.swapaxes(imodwt(MODWTResult(at, dt), w, boundary=boundary), -1, -2)

    col_approx = inv_rows(result.ll, result.hl)   # low-W bands: (low-H, high-H)
    col_detail = inv_rows(result.lh, result.hh)   # high-W bands
    return imodwt(MODWTResult(col_approx, col_detail), w, boundary=boundary)


class MultiLevelMODWT2Result(NamedTuple):
    """J-level 2-D MODWT: per-level (lh, hl, hh) triples + final ll."""

    details: tuple  # ((lh, hl, hh), ...) level 1..J
    approx: jnp.ndarray

    @property
    def levels(self) -> int:
        return len(self.details)

    def detail_energy(self, level: int) -> jnp.ndarray:
        lh, hl, hh = self.details[level - 1]
        return (lh**2 + hl**2 + hh**2).sum(axis=(-1, -2))


def _h_pass_pair(x, low, high, spacing, boundary):
    """Analysis pair along the H (row) axis: returns (low-H, high-H)."""
    xt = jnp.swapaxes(x, -1, -2)
    a, d = atrous_analysis_pair(xt, low, high, spacing=spacing, boundary=boundary)
    return jnp.swapaxes(a, -1, -2), jnp.swapaxes(d, -1, -2)


def _analysis2_level(x, low, high, spacing, boundary):
    a_w, d_w = atrous_analysis_pair(x, low, high, spacing=spacing, boundary=boundary)
    ll, hl = _h_pass_pair(a_w, low, high, spacing, boundary)
    lh, hh = _h_pass_pair(d_w, low, high, spacing, boundary)
    return MODWT2Result(ll=ll, lh=lh, hl=hl, hh=hh)


def modwt2_multilevel(
    x: jnp.ndarray,
    wavelet,
    *,
    levels: int,
    boundary: str = "periodic",
) -> MultiLevelMODWT2Result:
    """J-level separable 2-D MODWT with à trous spacing ``2^(j-1)`` at
    level j along BOTH axes (the 1-D cascade's convention,
    :func:`..multilevel.modwt_multilevel`), so level-j subbands isolate
    dyadic scale 2^j in H and W."""
    _check_2d(x, "modwt2_multilevel")
    if levels < 1:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_LEVEL, f"levels must be >= 1, got {levels}"
        )
    w = _resolve_discrete(wavelet)
    n_min = min(x.shape[-1], x.shape[-2])
    _check_level_fits(w, levels, n_min)
    low = w.dec_lo * _INV_SQRT2
    high = w.dec_hi * _INV_SQRT2
    details = []
    cur = x
    for level in range(1, levels + 1):
        spacing = 1 << (level - 1)
        res = _analysis2_level(cur, low, high, spacing, boundary)
        details.append((res.lh, res.hl, res.hh))
        cur = res.ll
    return MultiLevelMODWT2Result(tuple(details), cur)


def _inv_axis(a, d, low, high, spacing, boundary_l, w, level):
    """Per-level synthesis along the LAST axis, matching the 1-D multilevel
    conventions (adjoint indexing; symmetric uses the alignment table)."""
    if boundary_l.startswith("sym"):
        dec = _symmetric_alignment(w, level)
        tau_h = _tau_j(w.rec_lo.shape[0], level) + dec.delta_approx
        tau_g = _tau_j(w.rec_hi.shape[0], level) + dec.delta_detail
        rec_a = atrous_convolve(
            a, low, spacing=spacing, boundary="symmetric",
            sign=+1 if dec.approx_plus else -1,
            offset=-tau_h if dec.approx_plus else tau_h,
        )
        rec_d = atrous_convolve(
            d, high, spacing=spacing, boundary="symmetric",
            sign=+1 if dec.detail_plus else -1,
            offset=-tau_g if dec.detail_plus else tau_g,
        )
        return rec_a + rec_d
    rec_a = atrous_convolve(a, low, spacing=spacing, boundary=boundary_l, sign=+1)
    rec_d = atrous_convolve(d, high, spacing=spacing, boundary=boundary_l, sign=+1)
    return rec_a + rec_d


def imodwt2_multilevel(
    result: MultiLevelMODWT2Result,
    wavelet,
    *,
    boundary: str = "periodic",
) -> jnp.ndarray:
    w = _resolve_discrete(wavelet)
    low = w.rec_lo * _INV_SQRT2
    high = w.rec_hi * _INV_SQRT2
    boundary_l = boundary.lower()
    cur = result.approx
    for level in range(result.levels, 0, -1):
        lh, hl, hh = result.details[level - 1]
        spacing = 1 << (level - 1)

        def inv_h(a, d):
            at = jnp.swapaxes(a, -1, -2)
            dt = jnp.swapaxes(d, -1, -2)
            return jnp.swapaxes(
                _inv_axis(at, dt, low, high, spacing, boundary_l, w, level),
                -1, -2,
            )

        col_a = inv_h(cur, hl)   # low-W bands: (low-H, high-H)
        col_d = inv_h(lh, hh)    # high-W bands
        cur = _inv_axis(col_a, col_d, low, high, spacing, boundary_l, w, level)
    return cur


class DWT2Result(NamedTuple):
    """Single-level decimated 2-D DWT: [..., H/2, W/2] subbands."""

    ll: jnp.ndarray
    lh: jnp.ndarray
    hl: jnp.ndarray
    hh: jnp.ndarray


def dwt2(x: jnp.ndarray, wavelet, *, boundary: str = "periodic") -> DWT2Result:
    """Single-level separable decimated DWT (H and W must be even)."""
    _check_2d(x, "dwt2")
    col = dwt(x, wavelet, boundary=boundary)

    def rows(v):
        r = dwt(jnp.swapaxes(v, -1, -2), wavelet, boundary=boundary)
        return (
            jnp.swapaxes(r.approx, -1, -2),
            jnp.swapaxes(r.detail, -1, -2),
        )

    a = rows(col.approx)   # (low-H, high-H) of low-W
    d = rows(col.detail)   # (low-H, high-H) of high-W
    return DWT2Result(ll=a[0], lh=d[0], hl=a[1], hh=d[1])


def idwt2(result: DWT2Result, wavelet, *, boundary: str = "periodic") -> jnp.ndarray:
    def inv_rows(a, d):
        at = jnp.swapaxes(a, -1, -2)
        dt = jnp.swapaxes(d, -1, -2)
        return jnp.swapaxes(idwt(at, dt, wavelet, boundary=boundary), -1, -2)

    col_approx = inv_rows(result.ll, result.hl)   # low-W bands: (low-H, high-H)
    col_detail = inv_rows(result.lh, result.hh)   # high-W bands
    return idwt(col_approx, col_detail, wavelet, boundary=boundary)


def wavedec2(
    x: jnp.ndarray,
    wavelet,
    *,
    levels: int,
    boundary: str = "periodic",
):
    """J-level decimated 2-D pyramid; returns (details list, ll) with
    details[j-1] = (lh, hl, hh) at level j."""
    if levels < 1:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_LEVEL, f"levels must be >= 1, got {levels}"
        )
    _check_2d(x, "wavedec2")
    h_dim, w_dim = x.shape[-2], x.shape[-1]
    div = 1 << levels
    if h_dim % div or w_dim % div:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"Image dims {h_dim}x{w_dim} must be divisible by 2^levels = {div}",
            suggestions=("Reduce levels or pad the image",),
        )
    details = []
    cur = x
    for _ in range(levels):
        res = dwt2(cur, wavelet, boundary=boundary)
        details.append((res.lh, res.hl, res.hh))
        cur = res.ll
    return details, cur


def waverec2(details, ll, wavelet, *, boundary: str = "periodic") -> jnp.ndarray:
    cur = ll
    for lh, hl, hh in reversed(details):
        cur = idwt2(DWT2Result(cur, lh, hl, hh), wavelet, boundary=boundary)
    return cur


def denoise2(
    x: jnp.ndarray,
    wavelet,
    *,
    levels: int = 3,
    method: str = "universal",
    mode: str = "soft",
    boundary: str = "periodic",
) -> jnp.ndarray:
    """2-D denoising: threshold each detail subband per level with the
    sigma-scaled rule of the 1-D engine (finest HH estimates the noise).

    Subband statistics are computed over the WHOLE [H, W] plane (flattened),
    so sigma is one estimate per image and the universal threshold uses
    N = H*W — the 2-D VisuShrink rule; the result is H/W-symmetric."""
    from ..ops.thresholds import apply_threshold, mad_sigma, select_threshold

    def _flat(b):
        return b.reshape(*b.shape[:-2], -1)

    res = modwt2_multilevel(x, wavelet, levels=levels, boundary=boundary)
    sigma = mad_sigma(_flat(res.details[0][2]))  # finest diagonal band
    new_details = []
    for level, (lh, hl, hh) in enumerate(res.details, start=1):
        level_sigma = sigma / (2.0**level)  # two 1/sqrt(2) stages per level
        bands = []
        for b in (lh, hl, hh):
            # select_threshold keeps one trailing singleton (from the
            # flattened plane); add one more to broadcast over [..., H, W]
            thr = select_threshold(_flat(b), level_sigma, method)
            bands.append(apply_threshold(b, thr[..., None], mode))
        new_details.append(tuple(bands))
    return imodwt2_multilevel(
        MultiLevelMODWT2Result(tuple(new_details), res.approx),
        wavelet,
        boundary=boundary,
    )

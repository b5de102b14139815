"""Synchrosqueezing transform (SST): sharp time-frequency reassignment.

Beyond-reference capability (Daubechies–Lu–Wu synchrosqueezing): CWT energy
smeared across scales is reassigned to each coefficient's INSTANTANEOUS
frequency, collapsing a blurred scalogram ridge into a near-line — the
modern tool for resolving close modes and extracting them individually.

Implementation notes:

* The reassignment uses the wrap-free phase increment
  ``angle(W_{t+1} conj W_t)`` (no unwrapping, no finite-difference of
  angle) and executes as a STATIC loop over frequency bins of masked sums —
  XLA fuses it into one pass over the ``[S, N]`` field per bin; no
  data-dependent scatter shapes.
* The per-scale contribution weights are exactly the inverse-CWT
  single-sum weights (``dlog s / sqrt(s)``), so summing the squeezed
  transform over ALL bins reproduces the inverse-CWT accumulator
  identically — :func:`isst` therefore inherits the equalized inverse's
  near-exact band-limited reconstruction, and per-mode extraction is just
  a partial bin sum through the same equalizer.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import jax.numpy as jnp
import numpy as np

from ..errors import ErrorCode, InvalidArgumentError
from .cwt import (
    _aggregate_response,
    _resolve_continuous,
    cwt,
    validate_scales,
)
from .xwt import instantaneous_frequency

__all__ = [
    "SSTResult",
    "synchrosqueeze",
    "isst",
    "extract_mode",
    "dominant_frequencies",
]


class SSTResult(NamedTuple):
    """Synchrosqueezed transform ``[..., B, N]`` over frequency bins.

    ``freqs`` are the log-spaced bin centers (cycles/sample), ascending.
    ``scales``/``boundary`` record the originating CWT for inversion.
    """

    coeffs: jnp.ndarray
    freqs: np.ndarray
    scales: tuple[float, ...]
    boundary: str = "zero"

    @property
    def n_bins(self) -> int:
        return len(self.freqs)

    def power(self) -> jnp.ndarray:
        return jnp.abs(self.coeffs) ** 2


def _icwt_weights(scales: tuple[float, ...]) -> np.ndarray:
    log_s = np.log(np.asarray(scales))
    dls = np.gradient(log_s) if len(scales) > 1 else np.ones(1)
    return dls / np.sqrt(np.asarray(scales))


def synchrosqueeze(
    x: jnp.ndarray,
    scales: Sequence[float],
    wavelet="morl",
    *,
    n_bins: int | None = None,
    boundary: str = "zero",
    gamma: float = 0.0,
) -> SSTResult:
    """Synchrosqueezed CWT of a real signal.

    Computes the analytic CWT, estimates each coefficient's instantaneous
    frequency, and reassigns the (inverse-weighted) coefficient into the
    log-spaced frequency bin containing it.  ``gamma`` (absolute magnitude)
    optionally drops coefficients too small for a stable phase estimate.
    """
    w = _resolve_continuous(wavelet)
    scales = validate_scales(scales)
    if gamma < 0:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG, f"gamma must be >= 0, got {gamma}"
        )
    analytic = not bool(getattr(w, "is_complex", False))
    r = cwt(x, scales, w, analytic=analytic, boundary=boundary)
    inst = instantaneous_frequency(r)  # cycles/sample
    n_bins = len(scales) if n_bins is None else int(n_bins)
    if n_bins < 2:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG, f"n_bins must be >= 2, got {n_bins}"
        )
    f_grid = w.center_frequency / np.asarray(scales, dtype=np.float64)
    f_lo, f_hi = float(f_grid.min()), float(f_grid.max())
    freqs = np.geomspace(f_lo, f_hi, n_bins)
    dlf = math.log(f_hi / f_lo) / (n_bins - 1)

    weights = jnp.asarray(_icwt_weights(scales), r.coeffs.real.dtype)
    contrib = r.coeffs * weights[:, None]
    mag = jnp.abs(r.coeffs)
    # bin index per (scale, time); out-of-band or sub-gamma -> -1 (dropped)
    safe = (inst > 0) & (mag > gamma)
    logf = jnp.log(jnp.where(safe, inst, 1.0))
    idx = jnp.round((logf - math.log(f_lo)) / dlf).astype(jnp.int32)
    idx = jnp.where(safe & (idx >= 0) & (idx < n_bins), idx, -1)

    rows = []
    for b in range(n_bins):  # static loop -> one fused masked-sum per bin
        rows.append(jnp.where(idx == b, contrib, 0.0).sum(axis=-2))
    coeffs = jnp.stack(rows, axis=-2)  # [..., B, N]
    return SSTResult(coeffs, freqs, scales, boundary)


def _equalize(acc: jnp.ndarray, wavelet, scales, n: int, boundary: str):
    """icwt's aggregate-response equalizer applied to an accumulator row."""
    from .cwt import _device_complex

    w = _resolve_continuous(wavelet)
    g = _aggregate_response(w, scales, n, boundary)
    magr = np.abs(g)
    floor = 0.05 * magr.max()
    inv = np.where(magr > floor, 1.0 / np.where(magr > floor, g, 1.0), 0.0)
    spec = jnp.fft.rfft(acc, axis=-1)
    complex_dtype = jnp.complex128 if acc.dtype == jnp.float64 else jnp.complex64
    return jnp.fft.irfft(
        spec * _device_complex(inv, complex_dtype), n=n, axis=-1
    ).astype(acc.dtype)


def isst(result: SSTResult, wavelet="morl") -> jnp.ndarray:
    """Invert the synchrosqueezed transform (all bins).

    Because the reassignment preserved the inverse-CWT weights, summing the
    bins reproduces the single-sum accumulator; the equalized inverse then
    recovers the signal to the same accuracy as ``icwt`` (near-exact inside
    the band the scale grid covers; reassignment drops only out-of-band /
    non-positive instantaneous-frequency contributions).
    """
    acc = jnp.real(result.coeffs.sum(axis=-2))
    n = result.coeffs.shape[-1]
    return _equalize(acc, wavelet, result.scales, n, result.boundary)


def dominant_frequencies(result: SSTResult) -> jnp.ndarray:
    """Per-time frequency of the strongest bin ``[..., N]`` (cycles/sample)."""
    idx = jnp.abs(result.coeffs).argmax(axis=-2)
    return jnp.asarray(result.freqs)[idx]


def extract_mode(
    result: SSTResult,
    mode_freqs: jnp.ndarray,
    wavelet="morl",
    *,
    bandwidth_octaves: float = 0.5,
) -> jnp.ndarray:
    """Reconstruct one oscillatory mode from its frequency track.

    ``mode_freqs`` is a per-time frequency curve ``[..., N]`` (e.g. a
    constant, :func:`dominant_frequencies`, or a ridge mapped through
    ``scale_to_frequency``); bins within ``bandwidth_octaves/2`` of the
    curve are summed and equalized.
    """
    if bandwidth_octaves <= 0:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"bandwidth_octaves must be > 0, got {bandwidth_octaves}",
        )
    f_bins = jnp.asarray(result.freqs, result.coeffs.real.dtype)  # [B]
    ratio = jnp.log2(
        f_bins[:, None] / jnp.maximum(mode_freqs[..., None, :], 1e-12)
    )  # [..., B, N]
    mask = jnp.abs(ratio) <= bandwidth_octaves / 2.0
    acc = jnp.real((result.coeffs * mask).sum(axis=-2))
    n = result.coeffs.shape[-1]
    return _equalize(acc, wavelet, result.scales, n, result.boundary)

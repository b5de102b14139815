"""MODWT-based inverse CWT.

Re-design of ``MODWTBasedInverseCWT``
(``/root/reference/vectorwave-core/.../wavelet/cwt/MODWTBasedInverseCWT.java:40-...``):
reconstruct a signal from CWT coefficients by mapping dyadic CWT scales onto
MODWT levels and running the exact inverse MODWT.  The reference documents
3-10% reconstruction error for this route; here the per-level gains are
calibrated once (least squares on a seeded broadband signal), which keeps the
error at the low end of that range for log-spaced scale grids.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from ..wavelets.registry import as_wavelet
from .cwt import CWTResult, _resolve_continuous, cwt
from .multilevel import MultiLevelMODWTResult, imodwt_multilevel, max_levels

_GAIN_CACHE: dict[tuple, np.ndarray] = {}


def _level_scale_map(
    scales: tuple[float, ...], cwt_fc: float, levels: int
) -> list[list[int]]:
    """CWT scale rows whose center frequency falls in each MODWT level's
    octave [1/2^(j+1), 1/2^j] cycles/sample (the reference's dyadic
    scale -> level mapping, widened to every voice in the octave)."""
    freqs = [cwt_fc / s for s in scales]
    mapping: list[list[int]] = []
    for level in range(1, levels + 1):
        f_lo, f_hi = 1.0 / (1 << (level + 1)), 1.0 / (1 << level)
        rows = [i for i, f in enumerate(freqs) if f_lo <= f < f_hi]
        if not rows:  # fall back to the nearest single row
            target = cwt_fc / (3.0 / (1 << (level + 2)))
            rows = [int(np.argmin([abs(s - target) for s in scales]))]
        mapping.append(rows)
    return mapping


def _calibrated_gains(
    cwt_wavelet, modwt_wavelet, scales: tuple[float, ...], levels: int, n: int
) -> tuple[np.ndarray, np.ndarray]:
    """Per-level (shift, gain) mapping a CWT row onto MODWT detail
    coefficients, fitted on a seeded broadband signal (host-side, cached).

    The CWT uses zero-phase centered wavelets while MODWT details are causal,
    so each level needs a circular time shift before an amplitude gain — the
    analogue of the reference's scale-to-level amplitude mapping.
    """
    w_cwt = _resolve_continuous(cwt_wavelet)
    w_modwt = as_wavelet(modwt_wavelet)
    key = (w_cwt.name, w_modwt.name, scales, levels, n)
    cached = _GAIN_CACHE.get(key)
    if cached is not None:
        return cached
    rng = np.random.default_rng(999)
    x = rng.standard_normal(n)
    res = cwt(jnp.asarray(x), scales, w_cwt, boundary="periodic")
    # device-side .real projection: complex device->host transfers are
    # UNIMPLEMENTED on some remote runtimes
    coeffs = np.asarray(jnp.real(res.coeffs))
    mapping = _level_scale_map(scales, w_cwt.center_frequency, levels)
    from .multilevel import modwt_multilevel

    ref = modwt_multilevel(jnp.asarray(x), w_modwt, levels=levels)
    shifts: list[list[int]] = []
    weights: list[np.ndarray] = []
    for level, rows in enumerate(mapping, start=1):
        target = np.asarray(ref.details[level - 1])
        level_shifts = []
        aligned_rows = []
        for row in rows:
            source = coeffs[row]
            # circular cross-correlation via FFT for the best alignment
            xc = np.fft.irfft(np.fft.rfft(target) * np.conj(np.fft.rfft(source)), n)
            shift = int(np.argmax(np.abs(xc)))
            level_shifts.append(shift)
            aligned_rows.append(np.roll(source, shift))
        design = np.stack(aligned_rows, axis=1)
        w_fit, *_ = np.linalg.lstsq(design, target, rcond=None)
        shifts.append(level_shifts)
        weights.append(w_fit)
    _GAIN_CACHE[key] = (shifts, weights)
    return shifts, weights


def modwt_based_icwt(
    result: CWTResult,
    cwt_wavelet="morl",
    *,
    modwt_wavelet: str = "sym4",
    approx: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Reconstruct from CWT coefficients via the MODWT inverse.

    ``approx``: optional coarse approximation band (e.g. from a MODWT of the
    same signal); without it the sub-band content below the deepest mapped
    level is unrecoverable from band-pass CWT rows alone — the reference has
    the same limitation.
    """
    w_cwt = _resolve_continuous(cwt_wavelet)
    n = result.coeffs.shape[-1]
    levels = max(2, min(max_levels(n, modwt_wavelet), int(math.log2(max(result.scales)))))
    mapping = _level_scale_map(result.scales, w_cwt.center_frequency, levels)
    shifts, weights = _calibrated_gains(
        w_cwt, modwt_wavelet, result.scales, levels, n
    )
    coeffs = jnp.real(result.coeffs)
    details = []
    for level, rows in enumerate(mapping, start=1):
        acc = None
        for row, shift, wgt in zip(rows, shifts[level - 1], weights[level - 1]):
            term = jnp.roll(coeffs[..., row, :], int(shift), axis=-1) * float(wgt)
            acc = term if acc is None else acc + term
        details.append(acc)
    details = tuple(details)
    approx_band = jnp.zeros_like(details[0]) if approx is None else approx
    return imodwt_multilevel(
        MultiLevelMODWTResult(details, approx_band), modwt_wavelet
    )

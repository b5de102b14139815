"""Wavelet-domain long-memory analysis: Hurst estimation + variance change test.

Beyond-reference analysis capability (the reference's finance package
computes crash asymmetry and regime features but has no long-range-dependence
estimator; cf. ``FinancialWaveletAnalyzer.java``).  Two standard companions
of the Percival–Walden wavelet variance (ch. 9):

* :func:`hurst_exponent` — the Abry–Veitch log-scale regression.  For a
  process whose spectrum scales as ``f^-alpha``, the wavelet variance scales
  as ``nu_j^2 ~ tau_j^(alpha - 1)``; a weighted least-squares fit of
  ``log2 nu_j^2`` on ``log2 tau_j`` recovers the slope and hence the Hurst
  exponent (``H = (slope + 2) / 2`` for stationary fGn-like series,
  ``H = slope / 2`` for nonstationary fBm-like series).  The estimator uses
  the exact chi-squared small-sample corrections: the log of the variance
  estimate is debiased by ``psi(eta_j/2) - ln(eta_j/2)`` and weighted by the
  inverse of its variance ``psi'(eta_j/2)`` (Abry & Veitch 1998, eqs. 6-8).

* :func:`variance_change_test` — the Inclán–Tiao rotated-cumulative-sum test
  applied to boundary-free *decimated* (DWT) details at one level
  (Percival–Walden §9.6 use the DWT here precisely because its coefficients
  are approximately uncorrelated, unlike the redundant MODWT whose
  autocorrelated squares inflate the CUSUM and over-reject): under a
  constant-variance null the normalized CUSUM of squared coefficients
  converges to a Brownian bridge, so ``sqrt(M/2) * D`` follows the
  Kolmogorov distribution.  Returns the statistic, the critical value,
  and the argmax location mapped back to signal time.

Implementation notes: both are batched over leading axes and jittable end to
end — the regression is a closed-form weighted least squares over the level
axis (no host loop), the CUSUM test is one masked ``cumsum`` + reduction.
Critical values are tiny host-side scalar solves (bisection on the
Kolmogorov CDF), computed at trace time from static arguments.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
from jax.scipy.special import digamma, polygamma

from ..errors import ErrorCode, InvalidArgumentError
from ..ops.dwt import wavedec
from .modwt import _resolve_discrete
from .variance import wavelet_variance

__all__ = [
    "HurstResult",
    "VarianceChangeResult",
    "hurst_exponent",
    "variance_change_test",
    "kolmogorov_critical_value",
]

_LN2 = math.log(2.0)


class HurstResult(NamedTuple):
    """Batched long-memory fit (leading axes follow the input signal).

    ``slope`` is the raw log2-variance-vs-log2-scale slope (``alpha - 1``
    for an ``f^-alpha`` spectrum); ``hurst``/``stderr`` its model mapping.
    ``variance`` holds the per-level wavelet variances actually fitted and
    ``scales`` the corresponding ``tau_j``.
    """

    hurst: jnp.ndarray
    slope: jnp.ndarray
    intercept: jnp.ndarray
    stderr: jnp.ndarray
    variance: jnp.ndarray
    scales: np.ndarray

    @property
    def spectral_exponent(self) -> jnp.ndarray:
        """``alpha`` of the implied ``f^-alpha`` spectrum (= slope + 1)."""
        return self.slope + 1.0


def hurst_exponent(
    x: jnp.ndarray,
    wavelet="db4",
    levels: int | None = None,
    *,
    model: str = "fgn",
    min_level: int = 1,
    max_level: int | None = None,
    dt: float = 1.0,
) -> HurstResult:
    """Abry–Veitch wavelet estimate of the Hurst exponent.

    ``model="fgn"`` treats ``x`` as a stationary (fGn-like) series:
    ``H = (slope + 2) / 2`` — white noise gives ``H = 0.5``.
    ``model="fbm"`` treats ``x`` as a nonstationary random-walk-like series:
    ``H = slope / 2`` — a cumulative sum of white noise gives ``H = 0.5``.
    ``min_level``/``max_level`` bound the octaves entering the fit (drop
    fine scales contaminated by additive noise by raising ``min_level``).
    """
    model_l = model.lower()
    if model_l not in ("fgn", "fbm"):
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"model must be 'fgn' or 'fbm', got {model!r}",
        )
    r = wavelet_variance(x, wavelet, levels, dt=dt)
    j_hi = r.n_levels if max_level is None else max_level
    if not (1 <= min_level < j_hi <= r.n_levels):
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_LEVEL,
            f"need 1 <= min_level < max_level <= {r.n_levels} for a 2-point "
            f"fit, got min_level={min_level}, max_level={j_hi}",
        )
    sel = slice(min_level - 1, j_hi)
    var = r.variance[..., sel]
    eta = jnp.asarray(r.edof[sel], var.dtype)
    octave = jnp.arange(min_level - 1, j_hi, dtype=var.dtype)  # log2(tau_j/dt)

    # Debiased log2-variance and its exact chi-squared sampling variance.
    y = jnp.log2(jnp.maximum(var, jnp.finfo(var.dtype).tiny))
    y = y - (digamma(eta / 2.0) - jnp.log(eta / 2.0)) / _LN2
    w = (_LN2**2) / polygamma(1, eta / 2.0)  # inverse variance of y

    s0 = w.sum()
    s1 = (w * octave).sum()
    s2 = (w * octave * octave).sum()
    det = s0 * s2 - s1 * s1
    wy = (w * y).sum(axis=-1)
    wty = (w * octave * y).sum(axis=-1)
    slope = (s0 * wty - s1 * wy) / det
    intercept = (s2 * wy - s1 * wty) / det
    stderr_slope = jnp.sqrt(s0 / det)
    hurst = (slope + 2.0) / 2.0 if model_l == "fgn" else slope / 2.0
    return HurstResult(
        hurst,
        slope,
        intercept,
        jnp.broadcast_to(stderr_slope / 2.0, slope.shape),
        r.variance,
        r.scales,
    )


# ---------------------------------------------------------------------------
# Variance change-point test
# ---------------------------------------------------------------------------


class VarianceChangeResult(NamedTuple):
    """Inclán–Tiao test outcome; leading axes follow the input signal.

    ``statistic`` is ``sqrt(M/2) * max_k |CUSUM_k|`` (Kolmogorov-distributed
    under the constant-variance null), ``location`` the approximate
    signal-time index of the CUSUM argmax (the most likely change point;
    resolution is the decimation stride ``2^level``).
    """

    statistic: jnp.ndarray
    critical_value: float
    reject: jnp.ndarray
    location: jnp.ndarray
    level: int


def kolmogorov_critical_value(confidence: float) -> float:
    """Quantile of the Kolmogorov distribution ``K(x) = 1 - 2 sum (-1)^(k-1) exp(-2 k^2 x^2)``."""
    if not 0.0 < confidence < 1.0:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"confidence must be in (0, 1), got {confidence}",
        )

    def cdf(v: float) -> float:
        return 1.0 - 2.0 * sum(
            (-1.0) ** (k - 1) * math.exp(-2.0 * k * k * v * v)
            for k in range(1, 101)
        )

    lo, hi = 1e-3, 4.0
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if cdf(mid) < confidence:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def variance_change_test(
    x: jnp.ndarray,
    wavelet="db4",
    level: int = 1,
    *,
    confidence: float = 0.95,
) -> VarianceChangeResult:
    """Test for a variance change via the level-``level`` DWT details.

    The signal is truncated to a multiple of ``2^level``, decomposed with
    the decimated pyramid, and the first ``L'_j = ceil((L-2)(1-2^-j))``
    boundary-affected coefficients are dropped (Percival–Walden eq. 146b);
    the normalized rotated CUSUM of the remaining ``M`` squares is a
    Brownian bridge under homogeneity.  Decimated coefficients of a
    white-ish series are approximately uncorrelated, so the Kolmogorov
    null holds its nominal size (a redundant-MODWT version over-rejects —
    its squared coefficients are autocorrelated).
    """
    if level < 1:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_LEVEL, f"level must be >= 1, got {level}"
        )
    w = _resolve_discrete(wavelet)
    n = x.shape[-1]
    stride = 1 << level
    usable = (n // stride) * stride
    n_boundary = math.ceil((w.filter_length - 2) * (1.0 - 2.0**-level))
    m = usable // stride - n_boundary
    if m < 8:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_LEVEL,
            f"level {level} leaves {max(m, 0)} boundary-free DWT "
            f"coefficients at N={n}; need >= 8",
        )
    d = wavedec(
        x[..., :usable], w, levels=level, boundary="periodic"
    ).details[-1]
    sq = jnp.square(d[..., n_boundary:])
    total = sq.sum(axis=-1, keepdims=True)
    p = jnp.cumsum(sq, axis=-1) / jnp.maximum(total, jnp.finfo(sq.dtype).tiny)
    k = jnp.arange(1, m + 1, dtype=sq.dtype) / m
    dev = jnp.abs(p - k)
    stat = jnp.sqrt(m / 2.0) * dev.max(axis=-1)
    crit = kolmogorov_critical_value(confidence)
    loc = (n_boundary + 1 + dev.argmax(axis=-1)) * stride
    return VarianceChangeResult(stat, crit, stat > crit, loc, level)

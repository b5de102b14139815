"""Multifractal analysis via wavelet leaders (Wendt-Abry estimators).

Completes the long-memory toolkit (``transforms/longmemory.py``): where
:func:`hurst_exponent` fits ONE scaling exponent, this module estimates the
whole singularity spectrum ``D(h)`` — how densely each local regularity
exponent ``h`` occurs — distinguishing monofractal processes (fBm: a single
``h``) from multifractal ones (cascades, market volatility: a spread of
``h``).  Beyond the reference's scope (its analyses stop at single-exponent
statistics); the algorithm follows the wavelet-leader formulation of
Wendt & Abry (IEEE Trans. Signal Proc. 55(10), 2007), the modern
replacement for modulus-maxima chaining — and, unlike WTMM, fully batched:
leaders are running maxima over the dyadic tree (a ``log2`` cascade of
pairwise maxima + a 3-neighborhood max per level), and every estimator is a
weighted linear regression over levels, so the whole analysis is a few
dozen fused element-wise ops.

Estimators (q a static grid):

* ``zeta(q)``   — scaling exponents: slope over j of ``log2 S(q, j)``,
  ``S(q,j) = mean_k L_{j,k}^q``.
* ``h(q), D(q)`` — the singularity spectrum in parametric form, from the
  q-weighted log-statistics ``U(q,j) = sum R log2 L`` and
  ``V(q,j) = sum R log2 R`` with ``R = L^q / sum L^q``:
  ``h(q) = slope_j U``, ``D(q) = 1 + slope_j V`` (no numerical Legendre
  transform — exact at the estimator level).
* ``log-cumulants c1, c2`` — slope over j of the per-level mean/variance of
  ``log L``: c1 = typical regularity, c2 < 0 quantifies multifractality
  (c2 = 0 for monofractals).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import jax.numpy as jnp

from ..errors import ErrorCode, InvalidArgumentError
from ..ops.dwt import wavedec
from ..transforms.modwt import _resolve_discrete

__all__ = [
    "MultifractalResult",
    "wavelet_leaders",
    "multifractal_spectrum",
]


class MultifractalResult(NamedTuple):
    """Leader-based multifractal estimates over a static ``q`` grid."""

    qs: tuple[float, ...]
    zeta: jnp.ndarray  # [..., Q] scaling exponents
    h: jnp.ndarray  # [..., Q] regularity exponents (decreasing in q)
    D: jnp.ndarray  # [..., Q] spectrum values (<= 1)
    c1: jnp.ndarray  # [...] first log-cumulant slope (typical h)
    c2: jnp.ndarray  # [...] second log-cumulant slope (0 => monofractal)
    levels: tuple[int, ...]  # octaves used in the regressions

    def spectrum_width(self) -> jnp.ndarray:
        """``max h - min h`` over the q grid — 0 for a monofractal."""
        return jnp.max(self.h, axis=-1) - jnp.min(self.h, axis=-1)


def wavelet_leaders(
    x: jnp.ndarray,
    wavelet="db3",
    *,
    levels: int | None = None,
    boundary: str = "periodic",
) -> list[jnp.ndarray]:
    """Per-octave wavelet leaders ``L_j`` of ``[..., N]`` signals.

    ``L_{j,k} = sup |c_{j',k'}|`` over all coefficients at scales
    ``j' <= j`` whose support lies under the 3-neighborhood
    ``{k-1, k, k+1}`` of position ``k`` — computed as a pairwise-max
    cascade up the dyadic tree.  Coefficients use the L1 normalization
    (``2^{-j/2}`` x the DWT's L2 coefficients), the convention under which
    ``L_j ~ 2^{j h}`` at a point of regularity ``h``.
    """
    dec = wavedec(x, wavelet, levels=levels, boundary=boundary)
    leaders = []
    carry = None  # running sup over finer scales, at the previous resolution
    for j, detail in enumerate(dec.details, start=1):
        c_abs = jnp.abs(detail) * (2.0 ** (-j / 2.0))  # L1 normalization
        if carry is None:
            carry = c_abs
        else:
            n_half = 2 * (carry.shape[-1] // 2)
            pooled = jnp.maximum(
                carry[..., 0:n_half:2], carry[..., 1:n_half:2]
            )
            # odd leftover coefficient folds into the last parent
            if carry.shape[-1] % 2:
                pooled = pooled.at[..., -1].set(
                    jnp.maximum(pooled[..., -1], carry[..., -1])
                )
            pooled = pooled[..., : detail.shape[-1]]
            if pooled.shape[-1] < detail.shape[-1]:
                pad = detail.shape[-1] - pooled.shape[-1]
                pooled = jnp.concatenate(
                    [pooled, jnp.zeros(pooled.shape[:-1] + (pad,), pooled.dtype)],
                    axis=-1,
                )
            carry = jnp.maximum(c_abs, pooled)
        left = jnp.roll(carry, 1, axis=-1)
        right = jnp.roll(carry, -1, axis=-1)
        leaders.append(jnp.maximum(carry, jnp.maximum(left, right)))
    return leaders


def _fit_slope(ys: jnp.ndarray, js: np.ndarray, weights: np.ndarray) -> jnp.ndarray:
    """Weighted LS slope of ``ys`` ([..., J]) against octave numbers."""
    w = weights / weights.sum()
    jbar = float((w * js).sum())
    denom = float((w * (js - jbar) ** 2).sum())
    coef = w * (js - jbar) / denom
    return jnp.einsum("...j,j->...", ys, jnp.asarray(coef, dtype=ys.dtype))


def multifractal_spectrum(
    x: jnp.ndarray,
    wavelet="db3",
    *,
    qs: Sequence[float] = (-5, -3, -2, -1, -0.5, 0.5, 1, 2, 3, 5),
    min_level: int = 2,
    max_level: int | None = None,
    boundary: str = "periodic",
) -> MultifractalResult:
    """Estimate ``zeta(q)``, the singularity spectrum ``(h(q), D(q))`` and
    log-cumulants ``c1, c2`` from wavelet leaders of ``[..., N]`` signals.

    ``min_level`` discards the finest octaves (where discretization bites);
    ``max_level`` defaults to the deepest octave with at least 8 leaders.
    Regressions weight each octave by its leader count (the Wendt-Abry
    ``n_j`` weighting).
    """
    qs = tuple(float(q) for q in qs)
    if len(qs) == 0:
        raise InvalidArgumentError(
            ErrorCode.VAL_EMPTY_SIGNAL, "qs must be non-empty"
        )
    if any(q == 0.0 for q in qs):
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            "q = 0 is degenerate (S(0,j) == 1); use small +-q instead",
        )
    w = _resolve_discrete(wavelet)
    n = x.shape[-1]
    # deepest octave with >= 8 leaders, capped by the dyadic divisibility
    # the decimated cascade requires (N % 2^j == 0)
    divis = (n & -n).bit_length() - 1 if n else 0
    deepest = min(int(math.floor(math.log2(max(n // 8, 2)))), divis)
    if max_level is None:
        max_level = deepest
    max_level = min(max_level, deepest)
    if max_level < min_level + 1:
        raise InvalidArgumentError(
            ErrorCode.VAL_TOO_SHORT,
            f"Need at least two octaves in [{min_level}, {max_level}] "
            f"(signal length {n}); lower min_level or provide longer data",
        )
    leaders = wavelet_leaders(x, w, levels=max_level, boundary=boundary)
    # Periodic decimation wraps the signal ends together; a non-periodic
    # signal (fBm, prices) has an artificial jump there whose leaders would
    # dominate coarse-scale sups.  Trim the boundary-affected positions
    # (filter support + the 3-neighborhood) from the statistics.
    trim = w.filter_length
    trimmed = []
    for lam in leaders:
        n_j = lam.shape[-1]
        t = min(trim, max((n_j - 4) // 2, 0))
        trimmed.append(lam[..., t : n_j - t] if t else lam)
    leaders = trimmed
    js = np.arange(min_level, max_level + 1, dtype=np.float64)
    counts = np.array(
        [leaders[int(j) - 1].shape[-1] for j in js], dtype=np.float64
    )

    q_arr = jnp.asarray(qs, dtype=jnp.result_type(x.dtype, jnp.float32))
    log_s, u_stat, v_stat, m1, m2 = [], [], [], [], []
    for j in js:
        lam = leaders[int(j) - 1]
        # relative floor: an exactly-zero leader (flat segment + vanishing
        # moments) floored at finfo.tiny would overflow lam^q for q < 0;
        # 1e-7 keeps lam^q finite in float32 down to q = -5 while sitting
        # far below any genuine leader's dynamic range
        floor = 1e-7 * jnp.max(lam, axis=-1, keepdims=True)
        lam = jnp.maximum(lam, jnp.maximum(floor, jnp.finfo(lam.dtype).tiny))
        log_lam = jnp.log2(lam)
        # [..., Q, K] powers computed in MAX-SHIFTED log space so lam^q
        # stays finite in float32 for every |q| <= 5 regardless of the
        # leaders' absolute magnitude: S(q) = 2^(q log_max) mean(2^(q dlog))
        log_max = jnp.max(log_lam, axis=-1, keepdims=True)
        powed = jnp.exp2(
            q_arr[..., :, None] * (log_lam - log_max)[..., None, :]
        )
        s = jnp.mean(powed, axis=-1)
        r = powed / jnp.sum(powed, axis=-1, keepdims=True)
        log_s.append(q_arr * log_max[..., None, 0] + jnp.log2(s))
        u_stat.append(jnp.sum(r * log_lam[..., None, :], axis=-1))
        v_stat.append(jnp.sum(r * _safe_log2(r), axis=-1))
        m1.append(jnp.mean(log_lam, axis=-1))
        m2.append(jnp.var(log_lam, axis=-1))

    log_s = jnp.stack(log_s, axis=-1)  # [..., Q, J]
    u_stat = jnp.stack(u_stat, axis=-1)
    v_stat = jnp.stack(v_stat, axis=-1)
    zeta = _fit_slope(log_s, js, counts)
    h = _fit_slope(u_stat, js, counts)
    d = 1.0 + _fit_slope(v_stat + jnp.log2(jnp.asarray(counts, log_s.dtype)), js, counts)
    # cumulant convention: Cum_m[ln L_j] ~ c_m * j * ln 2, statistics here
    # are log2-based -> c1 = slope(mean log2 L), c2 = slope(var log2 L)*ln 2
    c1 = _fit_slope(jnp.stack(m1, axis=-1), js, counts)
    c2 = _fit_slope(jnp.stack(m2, axis=-1), js, counts) * math.log(2.0)
    return MultifractalResult(
        qs, zeta, h, d, c1, c2, tuple(int(j) for j in js)
    )


def _safe_log2(r: jnp.ndarray) -> jnp.ndarray:
    return jnp.log2(jnp.maximum(r, jnp.finfo(r.dtype).tiny))

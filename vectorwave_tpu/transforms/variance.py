"""MODWT wavelet variance / covariance / correlation (Percival–Walden ANOVA).

Beyond-reference analysis capability: the reference computes per-level
*energies* (``MultiLevelMODWTResult.getDetailEnergyAtLevel``) but not the
statistical wavelet-variance estimator, its confidence intervals, or the
cross-series covariance/correlation decomposition.  These are the standard
companions of a MODWT library (Percival & Walden, *Wavelet Methods for Time
Series Analysis*, ch. 8): the scale-by-scale decomposition of a process
variance,

    var(X) = sum_j nu_j^2,   nu_j^2 = E[d_{j,t}^2]  (MODWT detail at level j)

estimated unbiasedly by averaging only the ``M_j = N - L_j + 1`` coefficients
unaffected by the circular boundary (``L_j = (L-1)(2^j - 1) + 1``).

Implementation notes: all level loops are trace-time Python over static levels;
each estimator is a masked mean over the time axis (one fused reduction per
level), batched over leading axes, jittable end-to-end.  Confidence
intervals use the chi-squared equivalent-degrees-of-freedom approximation
``eta3 = max(M_j / 2^j, 1)`` with Wilson–Hilferty quantiles — no SciPy
dependency (the stdlib ``NormalDist`` supplies the normal quantile).
"""

from __future__ import annotations

import math
from typing import NamedTuple

from statistics import NormalDist

import jax.numpy as jnp
import numpy as np

from ..errors import ErrorCode, InvalidArgumentError
from .modwt import _resolve_discrete
from .multilevel import max_levels, modwt_multilevel

__all__ = [
    "WaveletVarianceResult",
    "VarianceStreamState",
    "variance_stream_init",
    "variance_stream_update",
    "variance_stream_result",
    "wavelet_variance",
    "wavelet_covariance",
    "wavelet_correlation",
]


class WaveletVarianceResult(NamedTuple):
    """Per-level estimates, each ``[..., J]`` (level ``j`` at index ``j-1``).

    ``edof`` carries the chi-squared equivalent degrees of freedom used for
    the interval; ``scales`` the physical scale ``tau_j = 2^(j-1) * dt``.
    """

    variance: jnp.ndarray
    ci_low: jnp.ndarray
    ci_high: jnp.ndarray
    edof: np.ndarray
    scales: np.ndarray

    @property
    def n_levels(self) -> int:
        return self.variance.shape[-1]


def _chi2_quantile(p: float, k: np.ndarray) -> np.ndarray:
    """Wilson–Hilferty chi-squared quantile (vectorized over dof ``k``)."""
    z = NormalDist().inv_cdf(p)
    h = 2.0 / (9.0 * k)
    return k * (1.0 - h + z * np.sqrt(h)) ** 3


def cascade_length(filter_length: int, level: int) -> int:
    """Cumulative level-j MODWT filter width ``L_j = (2^j - 1)(L - 1) + 1``.

    The à trous stage filter at level ``j`` spans ``(L-1)*2^(j-1)+1``
    samples of the *previous approximation*, but those approximations
    themselves reach further back; the composition over the cascade has
    exactly ``L_j`` support in the raw signal (Percival–Walden eq. 96a).
    Boundary-free coefficients are the ``t >= L_j - 1``.
    """
    return ((1 << level) - 1) * (filter_length - 1) + 1


def _interior_stats(
    details: tuple[jnp.ndarray, ...],
    other: tuple[jnp.ndarray, ...] | None,
    filter_length: int,
    n: int,
    unbiased: bool,
) -> tuple[jnp.ndarray, np.ndarray]:
    """Per-level mean of ``d_x * d_y`` over boundary-free coefficients.

    Returns (``[..., J]`` stats, ``[J]`` effective sample counts).
    """
    stats = []
    counts = np.empty(len(details))
    for j, d in enumerate(details, start=1):
        dy = d if other is None else other[j - 1]
        if unbiased:
            start = cascade_length(filter_length, j) - 1
            prod = (d * dy)[..., start:]
            counts[j - 1] = n - start
        else:
            prod = d * dy
            counts[j - 1] = n
        stats.append(prod.mean(axis=-1))
    return jnp.stack(stats, axis=-1), counts


def _resolve_levels(x, wavelet, levels, unbiased: bool) -> int:
    w = _resolve_discrete(wavelet)
    n = x.shape[-1]
    if unbiased:
        deepest = 0
        while cascade_length(w.filter_length, deepest + 1) <= n:
            deepest += 1
        deepest = min(deepest, max_levels(n, w))
    else:
        deepest = max(1, int(math.floor(math.log2(max(n, 2)))))
    if levels is None:
        return max(1, deepest)
    if levels < 1:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_LEVEL, f"levels must be >= 1, got {levels}"
        )
    if unbiased and cascade_length(w.filter_length, levels) > n:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_LEVEL,
            f"level {levels} has no boundary-free coefficients at N={n} "
            f"(L_j = {cascade_length(w.filter_length, levels)})",
            suggestions=(f"Use levels <= {deepest} or unbiased=False",),
        )
    return levels


def wavelet_variance(
    x: jnp.ndarray,
    wavelet="db4",
    levels: int | None = None,
    *,
    unbiased: bool = True,
    confidence: float = 0.95,
    dt: float = 1.0,
) -> WaveletVarianceResult:
    """Scale-by-scale variance decomposition with chi-squared intervals.

    ``unbiased=True`` (default) averages only boundary-free coefficients
    (Percival–Walden eq. 306); ``unbiased=False`` averages all ``N`` (the
    energy-decomposition estimator: summed over levels plus the approx term
    it reconstructs the full signal energy exactly).  Detail filters have
    zero sum, so the estimator ignores the series mean by construction.
    """
    w = _resolve_discrete(wavelet)
    levels = _resolve_levels(x, w, levels, unbiased)
    res = modwt_multilevel(x, w, levels=levels, boundary="periodic")
    var, counts = _interior_stats(
        res.details, None, w.filter_length, x.shape[-1], unbiased
    )
    edof = np.maximum(counts / np.exp2(np.arange(1, levels + 1)), 1.0)
    alpha = 1.0 - confidence
    q_hi = _chi2_quantile(1.0 - alpha / 2.0, edof)
    q_lo = _chi2_quantile(alpha / 2.0, edof)
    edof_j = jnp.asarray(edof, var.dtype)
    ci_low = edof_j * var / jnp.asarray(q_hi, var.dtype)
    ci_high = edof_j * var / jnp.asarray(q_lo, var.dtype)
    scales = (2.0 ** np.arange(levels)) * dt
    return WaveletVarianceResult(var, ci_low, ci_high, edof, scales)


def wavelet_covariance(
    x: jnp.ndarray,
    y: jnp.ndarray,
    wavelet="db4",
    levels: int | None = None,
    *,
    unbiased: bool = True,
    dt: float = 1.0,
) -> tuple[jnp.ndarray, np.ndarray]:
    """Per-level wavelet covariance of two series: ``([..., J], scales)``."""
    if x.shape[-1] != y.shape[-1]:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"series lengths differ: {x.shape[-1]} vs {y.shape[-1]}",
        )
    w = _resolve_discrete(wavelet)
    levels = _resolve_levels(x, w, levels, unbiased)
    rx = modwt_multilevel(x, w, levels=levels, boundary="periodic")
    ry = modwt_multilevel(y, w, levels=levels, boundary="periodic")
    cov, _ = _interior_stats(
        rx.details, ry.details, w.filter_length, x.shape[-1], unbiased
    )
    return cov, (2.0 ** np.arange(levels)) * dt


def wavelet_correlation(
    x: jnp.ndarray,
    y: jnp.ndarray,
    wavelet="db4",
    levels: int | None = None,
    *,
    unbiased: bool = True,
    dt: float = 1.0,
) -> tuple[jnp.ndarray, np.ndarray]:
    """Per-level wavelet correlation ``rho_j in [-1, 1]``: ``([..., J], scales)``."""
    w = _resolve_discrete(wavelet)
    levels = _resolve_levels(x, w, levels, unbiased)
    cov, scales = wavelet_covariance(
        x, y, w, levels, unbiased=unbiased, dt=dt
    )
    vx = wavelet_variance(x, w, levels, unbiased=unbiased).variance
    vy = wavelet_variance(y, w, levels, unbiased=unbiased).variance
    return cov / jnp.sqrt(vx * vy), scales


# ---------------------------------------------------------------------------
# Streaming (online) wavelet variance
# ---------------------------------------------------------------------------


class VarianceStreamState(NamedTuple):
    """Online accumulator: per-level sum of squared boundary-free details.

    A pytree carry (jittable, orbax-checkpointable) to compose with
    ``streaming.modwt_stream_block``: the unbiased estimator uses exactly
    the coefficients that involve no boundary extension (``t >= L_j - 1``),
    and those are identical between the zero-boundary streaming transform
    and the periodic whole-signal transform — so the streamed estimate
    EQUALS :func:`wavelet_variance` on the concatenated signal.
    """

    sumsq: jnp.ndarray  # [..., J]
    counts: jnp.ndarray  # [J] effective samples per level
    position: jnp.ndarray  # scalar int32: samples seen so far


def variance_stream_init(
    wavelet="db4",
    levels: int = 4,
    *,
    batch_shape: tuple[int, ...] = (),
    dtype=jnp.float32,
) -> VarianceStreamState:
    if levels < 1:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_LEVEL, f"levels must be >= 1, got {levels}"
        )
    _resolve_discrete(wavelet)
    return VarianceStreamState(
        jnp.zeros(batch_shape + (levels,), dtype),
        jnp.zeros((levels,), jnp.int32),
        jnp.zeros((), jnp.int32),
    )


def variance_stream_update(
    state: VarianceStreamState,
    details: tuple[jnp.ndarray, ...],
    wavelet,
) -> VarianceStreamState:
    """Fold one streamed block's detail coefficients into the accumulator.

    ``details`` is ``MultiLevelMODWTResult.details`` from
    ``modwt_stream_block(..., boundary="zero")``; jittable (the block
    length is static, the stream position is a traced scalar).
    """
    w = _resolve_discrete(wavelet)
    if len(details) != state.counts.shape[0]:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_LEVEL,
            f"state has {state.counts.shape[0]} levels, block has {len(details)}",
        )
    block_len = details[0].shape[-1]
    t_global = state.position + jnp.arange(block_len)
    sumsq = []
    counts = []
    for j, d in enumerate(details, start=1):
        start = cascade_length(w.filter_length, j) - 1
        mask = (t_global >= start).astype(d.dtype)
        sumsq.append(state.sumsq[..., j - 1] + (d * d * mask).sum(axis=-1))
        counts.append(state.counts[j - 1] + mask.sum().astype(jnp.int32))
    return VarianceStreamState(
        jnp.stack(sumsq, axis=-1),
        jnp.stack(counts),
        state.position + block_len,
    )


def variance_stream_result(
    state: VarianceStreamState,
    *,
    confidence: float = 0.95,
    dt: float = 1.0,
) -> WaveletVarianceResult:
    """Finalize the online estimate (variance + chi-squared intervals)."""
    levels = state.counts.shape[0]
    counts = np.maximum(np.asarray(state.counts), 1)
    var = state.sumsq / jnp.asarray(counts, state.sumsq.dtype)
    edof = np.maximum(counts / np.exp2(np.arange(1, levels + 1)), 1.0)
    alpha = 1.0 - confidence
    q_hi = _chi2_quantile(1.0 - alpha / 2.0, edof)
    q_lo = _chi2_quantile(alpha / 2.0, edof)
    edof_j = jnp.asarray(edof, var.dtype)
    ci_low = edof_j * var / jnp.asarray(q_hi, var.dtype)
    ci_high = edof_j * var / jnp.asarray(q_lo, var.dtype)
    scales = (2.0 ** np.arange(levels)) * dt
    return WaveletVarianceResult(var, ci_low, ci_high, edof, scales)

"""Thresholding and noise-estimation primitives (pure jnp, jit-safe).

Re-design of the reference's threshold kernels and selection rules
(``/root/reference/vectorwave-core/.../wavelet/internal/ScalarOps.java:1013-1044``
soft/hard apply; ``denoising/WaveletDenoiser.java:372-546`` sigma estimation and
UNIVERSAL/SURE/MINIMAX/BAYES selection).  Everything is expressed as
vectorized array ops (sort + cumulative sums replace the reference's O(n^2)
SURE scan) so thresholds are computed on-device inside jit.
"""

from __future__ import annotations

import math

import numpy as np
import jax.numpy as jnp
from jax.scipy.special import erfc

#: MAD -> sigma scale for Gaussian noise (WaveletDenoiser.java:384)
MAD_SCALE = 0.6745

#: Cai-Silverman block-shrinkage risk constant (the root of L - log L = 3)
BLOCK_LAMBDA = 4.50524


def soft_threshold(coeffs: jnp.ndarray, threshold) -> jnp.ndarray:
    """Soft thresholding: sign(c) * max(|c| - t, 0) (ScalarOps.softThreshold)."""
    return jnp.sign(coeffs) * jnp.maximum(jnp.abs(coeffs) - threshold, 0.0)


def hard_threshold(coeffs: jnp.ndarray, threshold) -> jnp.ndarray:
    """Hard thresholding: c * 1[|c| > t] (ScalarOps.hardThreshold)."""
    return jnp.where(jnp.abs(coeffs) > threshold, coeffs, 0.0)


def apply_threshold(coeffs: jnp.ndarray, threshold, mode: str = "soft") -> jnp.ndarray:
    mode_l = mode.lower()
    if mode_l == "soft":
        return soft_threshold(coeffs, threshold)
    if mode_l == "hard":
        return hard_threshold(coeffs, threshold)
    from ..errors import ErrorCode, InvalidArgumentError

    raise InvalidArgumentError(
        ErrorCode.CFG_INVALID_CONFIG,
        f"Unknown threshold type: {mode!r}",
        suggestions=("Use 'soft' or 'hard'",),
    )


def _middle_order_stats(v: jnp.ndarray) -> jnp.ndarray:
    """[..., R] middle order statistic(s) of |v| (R = 2 for even n).

    Radix-16 MSB->LSB search on the int32 bit pattern (non-negative f32
    order-matches its bits): 8 sequential counting passes instead of the
    round-3 bitwise search's 31 — each pass counts strictly-below for the
    15 candidate nibble extensions at once (monotone in the nibble, so the
    nibble is just the number of satisfied candidates).  Bit-exact order
    statistics, guarded against jnp.median in tests.
    """
    import jax

    mag = jnp.abs(v)
    if mag.dtype != jnp.float32:
        mag = mag.astype(jnp.float32)
    n = mag.shape[-1]
    bits = jax.lax.bitcast_convert_type(mag, jnp.int32)
    lead = mag.shape[:-1]
    # ranks (1-indexed) of the middle order statistic(s)
    ks = (n // 2, n // 2 + 1) if n % 2 == 0 else (n // 2 + 1,)
    k_arr = jnp.asarray(ks, dtype=jnp.int32)  # [R]
    cand = jnp.zeros(lead + (len(ks),), jnp.int32)
    # bit 31 is the sign (always 0 for magnitudes): groups cover bits 30..0
    groups = ((28, 8),) + tuple((p, 16) for p in range(24, -1, -4))
    for p, m in groups:
        js = jnp.arange(1, m, dtype=jnp.int32) << p  # [m-1]
        trials = cand[..., :, None] | js  # [..., R, m-1]
        cnt = jnp.sum(
            (bits[..., :, None, None] < trials[..., None, :, :]),
            axis=-3, dtype=jnp.int32,
        )  # [..., R, m-1]
        # f(trial) < k is monotone non-increasing in the nibble value, so
        # the chosen nibble = number of candidates still below rank k
        nibble = jnp.sum(
            (cnt < k_arr[..., :, None]), axis=-1, dtype=jnp.int32
        )
        cand = cand | (nibble << p)
    return jax.lax.bitcast_convert_type(cand, jnp.float32)


def median_magnitude(v: jnp.ndarray) -> jnp.ndarray:
    """Exact median of ``|v|`` along the last axis, without a sort.

    ``jnp.median`` lowers to a full per-signal SORT, which can cost more
    than the denoise transform itself.  Non-negative f32
    values order-match their int32 bit patterns, so the k-th order
    statistic is a 31-step binary search on the bit pattern: build the
    answer MSB->LSB, keeping a candidate bit iff fewer than k elements are
    strictly below the candidate.  Both middle order stats (even n) ride
    the same counting passes: O(31 n) streaming compares instead of an
    O(n log n) sort, matching ``jnp.median`` bit-for-bit (guarded in
    tests).

    Differentiable via a custom JVP (the bit search itself has no
    derivative): the exact subgradient routes through the positions that
    attain the middle order statistics, matching ``jnp.median``'s
    piecewise-linear behavior (averaged over ties).
    """
    return _median_magnitude_jvp(v)


import jax as _jax


@_jax.custom_jvp
def _median_magnitude_jvp(v):
    vals = _middle_order_stats(v)
    return jnp.mean(vals, axis=-1, keepdims=True).astype(v.dtype)


@_median_magnitude_jvp.defjvp
def _median_magnitude_jvp_rule(primals, tangents):
    (v,), (dv,) = primals, tangents
    vals = _middle_order_stats(v)  # [..., R]
    out = jnp.mean(vals, axis=-1, keepdims=True).astype(v.dtype)
    mag = jnp.abs(v).astype(jnp.float32)
    dvals = []
    for r in range(vals.shape[-1]):
        val = vals[..., r : r + 1]
        mask = (mag == val).astype(jnp.float32)
        wsum = jnp.sum(mask, axis=-1, keepdims=True)
        w = mask / jnp.maximum(wsum, 1.0)
        dvals.append(
            jnp.sum(w * jnp.sign(v) * dv.astype(jnp.float32), axis=-1,
                    keepdims=True)
        )
    dout = (sum(dvals) / len(dvals)).astype(v.dtype)
    return out, dout


def mad_sigma(detail: jnp.ndarray) -> jnp.ndarray:
    """Noise sigma via median absolute deviation of detail coefficients
    (WaveletDenoiser.estimateNoiseSigma :380-384): median(|d|) / 0.6745.

    Computed per signal along the last axis; the result keeps a trailing
    singleton axis so it broadcasts against ``[..., N]`` coefficients.
    The median uses the sort-free bitwise order-statistic search
    (:func:`median_magnitude`) — exact, and sort-free (not measured against
    ``jnp.median`` on the H100).
    """
    return median_magnitude(detail) / MAD_SCALE


def universal_threshold(n: int, sigma) -> jnp.ndarray:
    """VisuShrink: sigma * sqrt(2 ln N) (WaveletDenoiser.java:398-400)."""
    return sigma * jnp.sqrt(2.0 * jnp.log(float(n)))


def sure_threshold(coeffs: jnp.ndarray, sigma) -> jnp.ndarray:
    """SURE threshold: minimize Stein's unbiased risk over candidate thresholds
    (WaveletDenoiser.calculateSUREThreshold :440-493), capped at universal.

    Vectorized per signal along the last axis: with s = sorted(|c|), the risk
    at t = s[k] is
    ``(-n sigma^2 + sum_{i<=k} s_i^2 + sum_{i>k} [sigma^2 + (s_i - s_k)^2]) / n``
    computed for all k via prefix sums (O(n log n) vs the reference's O(n^2)).
    """
    n = coeffs.shape[-1]
    sigma = jnp.asarray(sigma)
    s = jnp.sort(jnp.abs(coeffs), axis=-1)
    s2 = s * s
    cum_s2 = jnp.cumsum(s2, axis=-1)
    cum_s = jnp.cumsum(s, axis=-1)
    above_s2 = cum_s2[..., -1:] - cum_s2  # sum_{i>k} s_i^2
    above_s = cum_s[..., -1:] - cum_s  # sum_{i>k} s_i
    count_above = (n - 1 - jnp.arange(n)).astype(coeffs.dtype)
    sigma2 = sigma * sigma
    risk = (
        -n * sigma2
        + cum_s2
        + count_above * sigma2
        + above_s2
        - 2.0 * s * above_s
        + count_above * s2
    ) / n
    best = jnp.take_along_axis(s, jnp.argmin(risk, axis=-1, keepdims=True), axis=-1)
    return jnp.minimum(best, universal_threshold(n, sigma))


def minimax_threshold(n: int, sigma) -> jnp.ndarray:
    """Minimax piecewise approximation (WaveletDenoiser.java:496-509)."""
    sigma = jnp.asarray(sigma)
    if n <= 32:
        return jnp.zeros_like(sigma)
    log_n = jnp.log(float(n))
    if n <= 64:
        return sigma * 0.3936 + 0.1829 * sigma * log_n
    return sigma * (0.4745 + 0.1148 * log_n)


def bayes_threshold(coeffs: jnp.ndarray, sigma, eps: float = 1e-10) -> jnp.ndarray:
    """BayesShrink: T = sigma^2 / sigma_x, sigma_x^2 = max(0, var(c) - sigma^2)
    (WaveletDenoiser.calculateBayesThreshold :519-547)."""
    sigma = jnp.asarray(sigma)
    sigma2 = sigma * sigma
    variance = jnp.var(coeffs, axis=-1, keepdims=True)
    sigma_x = jnp.sqrt(jnp.maximum(0.0, variance - sigma2) + eps)
    return sigma2 / sigma_x


def fdr_threshold(coeffs: jnp.ndarray, sigma, q: float = 0.05) -> jnp.ndarray:
    """False-discovery-rate threshold (Abramovich-Benjamini).

    Beyond the reference's four selection rules (``WaveletDenoiser.java:393-436``):
    treats each coefficient as a test of "is this pure noise", sorts the
    two-sided p-values ``p_i = 2(1 - Phi(|c_i|/sigma))`` and picks the largest
    k with ``p_(k) <= q k / n`` — the threshold adapts to how many
    coefficients genuinely carry signal, keeping more of a dense signal than
    VisuShrink and killing more of a sparse one — which means the threshold
    may exceed the universal threshold (that's the point: a non-significant
    outlier above VisuShrink still dies).  If nothing is significant
    everything is killed (threshold = ``max |c|``).  Vectorized per signal
    along the last axis.
    """
    n = coeffs.shape[-1]
    sigma = jnp.asarray(sigma)
    s = jnp.sort(jnp.abs(coeffs), axis=-1)[..., ::-1]  # descending
    # two-sided Gaussian p-value: erfc(x / (sigma sqrt(2))) = 2 (1 - Phi(x/sigma))
    pvals = erfc(s / (sigma * math.sqrt(2.0) + 1e-30))
    crit = q * jnp.arange(1, n + 1, dtype=coeffs.dtype) / n
    ok = pvals <= crit
    found = jnp.any(ok, axis=-1, keepdims=True)
    # index of the LAST satisfied criterion (first hit from the right)
    last = n - 1 - jnp.argmax(ok[..., ::-1], axis=-1, keepdims=True)
    t_found = jnp.take_along_axis(s, last, axis=-1)
    t_none = s[..., :1]  # kill everything
    return jnp.where(found, t_found, t_none)


def block_shrink(
    coeffs: jnp.ndarray,
    sigma,
    *,
    block_size: int | None = None,
    lam: float = BLOCK_LAMBDA,
) -> jnp.ndarray:
    """NeighBlock James-Stein block shrinkage (Cai-Silverman 2001).

    Beyond the reference's term-by-term rules: coefficients are shrunk in
    blocks of ``L0 = floor(log n / 2)`` using the energy ``S_b`` of an
    extended window (``L1 = floor(L0/2)`` extra samples each side),

        c_b <- c_b * max(0, 1 - lam * L * sigma^2 / S_b),

    so a strong neighbour rescues a weak coefficient inside a feature and
    isolated noise blocks are zeroed wholesale — lower risk than soft
    thresholding on signals with localized structure.  Windows are clamped at
    the edges (``L`` is the actual window length per block).  Pure jnp,
    vectorized along the last axis; all indices are static so the whole
    shrink fuses into the surrounding jit graph.
    """
    n = coeffs.shape[-1]
    if block_size is None:
        block_size = max(1, int(math.log(max(n, 2)) / 2.0))
    l0 = max(1, int(block_size))
    l1 = max(1, l0 // 2)
    nb = -(-n // l0)
    starts = np.clip(np.arange(nb) * l0 - l1, 0, n)
    ends = np.clip(np.arange(nb) * l0 + l0 + l1, 0, n)
    c2 = coeffs * coeffs
    csum = jnp.concatenate(
        [jnp.zeros(coeffs.shape[:-1] + (1,), coeffs.dtype), jnp.cumsum(c2, axis=-1)],
        axis=-1,
    )
    energy = csum[..., ends] - csum[..., starts]  # [..., nb]
    win_len = jnp.asarray(ends - starts, dtype=coeffs.dtype)
    sigma = jnp.asarray(sigma)
    factor = jnp.maximum(
        0.0, 1.0 - lam * win_len * sigma * sigma / (energy + 1e-30)
    )
    idx_map = np.minimum(np.arange(n) // l0, nb - 1)
    return coeffs * factor[..., idx_map]


def select_threshold(coeffs: jnp.ndarray, sigma, method: str):
    """Dispatch on threshold-selection method (calculateThreshold :393-436).

    ``method`` is static (resolved at trace time).  ``sigma`` has a trailing
    singleton axis (from :func:`mad_sigma`); the returned threshold broadcasts
    against ``coeffs``.
    """
    method_l = method.lower()
    n = int(coeffs.shape[-1])
    if method_l == "universal":
        return universal_threshold(n, sigma)
    if method_l == "sure":
        return sure_threshold(coeffs, sigma)
    if method_l == "minimax":
        return minimax_threshold(n, sigma)
    if method_l in ("bayes", "bayesshrink"):
        return bayes_threshold(coeffs, sigma)
    if method_l == "fdr":
        return fdr_threshold(coeffs, sigma)
    from ..errors import ErrorCode, InvalidArgumentError

    raise InvalidArgumentError(
        ErrorCode.CFG_INVALID_CONFIG,
        f"Unknown threshold method: {method!r}",
        suggestions=(
            "Use 'universal', 'sure', 'minimax', 'bayes' or 'fdr'",
            "For a fixed threshold call denoise_fixed()",
            "For block shrinkage call denoise_block()",
        ),
    )

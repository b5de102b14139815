"""Signal padding strategies.

Re-design of the reference's sealed strategy hierarchy
(``/root/reference/vectorwave-core/.../wavelet/padding/*.java`` — 12
strategies): one functional entry point :func:`pad_signal` with a strategy
name, plus :func:`adaptive_strategy` reproducing the adaptive chooser's
signal analysis (``AdaptivePaddingStrategy.java:37-...``: smoothness, trend,
periodicity and stationarity heuristics).

All deterministic strategies are pure jnp and jittable (static pad widths).
Alignment follows the reference's RIGHT / LEFT / SYMMETRIC modes.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .errors import ErrorCode, InvalidArgumentError

STRATEGIES = (
    "zero",
    "constant",
    "periodic",
    "symmetric",
    "reflect",
    "antisymmetric",
    "linear_extrapolation",
    "polynomial_extrapolation",
    "statistical",
    "composite",
    "adaptive",
)


def _extend(x: jnp.ndarray, left: int, right: int, strategy: str, options) -> jnp.ndarray:
    """Return x extended by `left`/`right` samples on each side."""
    n = x.shape[-1]
    if strategy == "zero":
        return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(left, right)])
    if strategy == "constant":  # repeat edge values (ConstantPaddingStrategy)
        return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(left, right)], mode="edge")
    if strategy == "periodic":
        return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(left, right)], mode="wrap")
    if strategy == "symmetric":  # half-point mirror, edge repeated
        return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(left, right)], mode="symmetric")
    if strategy == "reflect":  # whole-point mirror, edge not repeated
        return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(left, right)], mode="reflect")
    if strategy == "antisymmetric":
        # half-point antisymmetry: x[-1-k] = 2*edge - x[k] mirrored with sign
        idx_l = jnp.arange(left - 1, -1, -1) if left else jnp.arange(0)
        idx_r = jnp.arange(n - 1, n - 1 - right, -1) if right else jnp.arange(0)
        left_part = 2 * x[..., :1] - x[..., idx_l] if left else x[..., :0]
        right_part = 2 * x[..., -1:] - x[..., idx_r] if right else x[..., :0]
        return jnp.concatenate([left_part, x, right_part], axis=-1)
    if strategy == "linear_extrapolation":
        # fit the last/first two samples (LinearExtrapolationStrategy)
        slope_r = x[..., -1:] - x[..., -2:-1]
        slope_l = x[..., 1:2] - x[..., :1]
        kr = jnp.arange(1, right + 1, dtype=x.dtype)
        kl = jnp.arange(left, 0, -1, dtype=x.dtype)
        right_part = x[..., -1:] + slope_r * kr if right else x[..., :0]
        left_part = x[..., :1] - slope_l * kl if left else x[..., :0]
        return jnp.concatenate([left_part, x, right_part], axis=-1)
    if strategy == "polynomial_extrapolation":
        order = int(options.get("order", 3))
        window = int(options.get("window", max(2 * (order + 1), 8)))
        window = min(window, n)
        t_fit = np.arange(window, dtype=np.float64)
        # Vandermonde pseudo-inverses are static; evaluation is traced.
        vand = np.vander(t_fit, order + 1, increasing=True)
        pinv = jnp.asarray(np.linalg.pinv(vand), dtype=x.dtype)
        coef_r = jnp.einsum("ij,...j->...i", pinv, x[..., -window:])
        coef_l = jnp.einsum("ij,...j->...i", pinv, jnp.flip(x[..., :window], axis=-1))
        powers_r = jnp.asarray(
            np.vander(np.arange(window, window + right, dtype=np.float64), order + 1, increasing=True),
            dtype=x.dtype,
        )
        powers_l = jnp.asarray(
            np.vander(np.arange(window, window + left, dtype=np.float64), order + 1, increasing=True),
            dtype=x.dtype,
        )
        right_part = jnp.einsum("kj,...j->...k", powers_r, coef_r) if right else x[..., :0]
        left_part = (
            jnp.flip(jnp.einsum("kj,...j->...k", powers_l, coef_l), axis=-1)
            if left
            else x[..., :0]
        )
        return jnp.concatenate([left_part, x, right_part], axis=-1)
    if strategy == "statistical":
        method = options.get("method", "mean")
        if method == "mean":
            fill = jnp.mean(x, axis=-1, keepdims=True)
        elif method == "median":
            fill = jnp.median(x, axis=-1, keepdims=True)
        else:
            raise InvalidArgumentError(
                ErrorCode.CFG_INVALID_CONFIG,
                f"Unknown statistical padding method: {method!r}",
                suggestions=("Use 'mean' or 'median'",),
            )
        shape_l = x.shape[:-1] + (left,)
        shape_r = x.shape[:-1] + (right,)
        return jnp.concatenate(
            [jnp.broadcast_to(fill, shape_l), x, jnp.broadcast_to(fill, shape_r)],
            axis=-1,
        )
    if strategy == "composite":
        # different strategies per side (CompositePaddingStrategy)
        left_strategy = options.get("left", "symmetric")
        right_strategy = options.get("right", "symmetric")
        with_left = _extend(x, left, 0, left_strategy, options)
        with_right = _extend(x, 0, right, right_strategy, options)
        return jnp.concatenate([with_left[..., :left], with_right], axis=-1)
    raise InvalidArgumentError(
        ErrorCode.CFG_INVALID_CONFIG,
        f"Unknown padding strategy: {strategy!r}",
        suggestions=(f"Use one of {STRATEGIES}",),
    )


def adaptive_strategy(x: np.ndarray) -> str:
    """Pick a padding strategy from signal characteristics
    (``AdaptivePaddingStrategy``: smoothness / trend / periodicity /
    stationarity analysis).  Host-side (data-dependent choice)."""
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    n = len(x)
    if n < 8:
        return "symmetric"
    # periodicity: autocorrelation peak AFTER decorrelation (a slow trend has
    # high autocorrelation at every lag — require the correlation to first
    # drop below 0.2 and then recover, which distinguishes true periodicity)
    centered = x - x.mean()
    denom = float(np.dot(centered, centered)) + 1e-30
    max_lag = min(n // 2, 256)
    ac = np.correlate(centered, centered, mode="full")[n - 1 : n - 1 + max_lag] / denom
    below = np.nonzero(ac < 0.2)[0]
    periodicity = float(ac[below[0] :].max()) if below.size else 0.0
    # trend: linear fit R^2
    t = np.arange(n)
    slope, intercept = np.polyfit(t, x, 1)
    resid = x - (slope * t + intercept)
    r2 = 1.0 - float(np.dot(resid, resid)) / denom if denom > 0 else 0.0
    # smoothness: first-difference energy ratio
    diff = np.diff(x)
    roughness = float(np.dot(diff, diff)) / denom
    if periodicity > 0.8:
        return "periodic"
    if r2 > 0.85:
        return "linear_extrapolation"
    if roughness < 0.05:
        return "polynomial_extrapolation"
    return "symmetric"


def pad_signal(
    x: jnp.ndarray,
    target_length: int,
    strategy: str = "symmetric",
    *,
    align: str = "right",
    **options,
) -> jnp.ndarray:
    """Pad ``x`` (last axis) to ``target_length`` using ``strategy``.

    ``align`` places the original samples: ``right`` pads after the signal,
    ``left`` before, ``symmetric`` splits the padding
    (reference: PaddingStrategy pad() + alignment modes).
    """
    n = x.shape[-1]
    if target_length < n:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"Target length {target_length} must be >= signal length {n}",
        )
    pad_total = target_length - n
    if pad_total == 0:
        return x
    strategy_l = strategy.lower()
    if strategy_l == "adaptive":
        strategy_l = adaptive_strategy(np.asarray(x))
    align_l = align.lower()
    if align_l == "right":
        left, right = 0, pad_total
    elif align_l == "left":
        left, right = pad_total, 0
    elif align_l == "symmetric":
        left = pad_total // 2
        right = pad_total - left
    else:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"Unknown padding alignment: {align!r}",
            suggestions=("Use 'right', 'left' or 'symmetric'",),
        )
    return _extend(x, left, right, strategy_l, options)

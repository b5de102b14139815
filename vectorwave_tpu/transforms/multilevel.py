"""Multi-level MODWT decomposition / reconstruction (à trous cascade).

Re-design of ``MultiLevelMODWTTransform``
(``/root/reference/vectorwave-core/.../wavelet/modwt/MultiLevelMODWTTransform.java:82-824``)
and its internal ``SymmetricAlignmentStrategy`` (``SymmetricAlignmentStrategy.java:23-120``).

Scaling convention (the bit-parity invariant, ``ScalarOps.java:909-916`` and
``MultiLevelMODWTTransform.java:656-665``): BOTH analysis and synthesis use the
level-j à trous filter built by upsampling the base filter with ``2^(j-1)-1``
zeros and scaling by ``1/sqrt(2)`` *per stage*; the cascade composes the stage
scalings into the textbook ``2^(-j/2)``.  We never materialize the upsampled
filter — the convolution ops take the base filter plus a stride, so the
inserted zeros are never touched.

The level loop is a Python unroll (J <= 10, static at trace time) so every
level's stride and filter are compile-time constants for XLA.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..errors import ErrorCode, InvalidArgumentError
from ..ops.convolve import atrous_analysis_pair, atrous_convolve, effective_length
from ..wavelets.base import DiscreteWavelet
from .modwt import _resolve_discrete, _validate_signal

_INV_SQRT2 = 1.0 / math.sqrt(2.0)

#: Hard cap on decomposition depth (MultiLevelMODWTTransform.MAX_DECOMPOSITION_LEVELS).
MAX_DECOMPOSITION_LEVELS = 10


class MultiLevelMODWTResult(NamedTuple):
    """Multi-level MODWT coefficients (reference: MultiLevelMODWTResultImpl).

    ``details[j-1]`` holds the level-j detail coefficients; ``approx`` is the
    final (coarsest) approximation.  All arrays share the input shape.
    """

    details: tuple[jnp.ndarray, ...]
    approx: jnp.ndarray

    @property
    def levels(self) -> int:
        return len(self.details)

    @property
    def signal_length(self) -> int:
        return self.approx.shape[-1]

    def detail_energy(self, level: int) -> jnp.ndarray:
        """Energy of one detail level (getDetailEnergyAtLevel)."""
        return (self.details[level - 1] ** 2).sum(axis=-1)

    def approx_energy(self) -> jnp.ndarray:
        return (self.approx**2).sum(axis=-1)

    def total_energy(self) -> jnp.ndarray:
        total = self.approx_energy()
        for d in self.details:
            total = total + (d**2).sum(axis=-1)
        return total

    def relative_energy_distribution(self) -> jnp.ndarray:
        """Per-level relative energies ``[levels+1]`` ordered detail 1..J, approx
        (getRelativeEnergyDistribution)."""
        energies = [(d**2).sum(axis=-1) for d in self.details] + [self.approx_energy()]
        stacked = jnp.stack(energies, axis=-1)
        return stacked / stacked.sum(axis=-1, keepdims=True)


#: Requested max |error| -> precision tier.  Budgets at or above the
#: float32 bound are met by the float32 cascade (round-trip RMSE ~1.6e-7 on
#: unit-variance input); tighter budgets run the cascade in float64.
_FLOAT32_MIN_TOLERANCE = 3e-6


def resolve_tolerance(tolerance: float) -> str:
    """Map a requested max error to a precision tier (``float32 | exact``).

    The reference's public API is f64 end-to-end and its default round
    trip meets <1e-9 (ModwtPeriodicRoundTripTest.java:37); the ``exact``
    tier makes that contract reachable without knowing the tier names:
    ``modwt_multilevel(x, w, tolerance=1e-10)`` runs the float64 cascade.
    """
    if not (tolerance > 0):
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"tolerance must be positive, got {tolerance}",
        )
    return "float32" if tolerance >= _FLOAT32_MIN_TOLERANCE else "exact"


_VALID_PRECISIONS = ("float32", "exact")


def _resolve_tier(tolerance, precision) -> str | None:
    """Combine the ``tolerance=`` / ``precision=`` kwargs into a tier
    (explicit ``precision`` wins; both None = the input's own dtype)."""
    if precision is not None:
        if precision not in _VALID_PRECISIONS:
            raise InvalidArgumentError(
                ErrorCode.CFG_INVALID_CONFIG,
                f"Unknown precision {precision!r}",
                suggestions=(f"Use one of {_VALID_PRECISIONS}",),
            )
        return precision
    if tolerance is not None:
        return resolve_tolerance(tolerance)
    return None


def _as_float64(x: jnp.ndarray) -> jnp.ndarray:
    """Upcast for the exact tier, which needs 64-bit mode to exist."""
    if not jax.config.jax_enable_x64:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            "The exact tier (tolerance below 3e-6 or precision='exact') runs "
            "the cascade in float64, which needs jax_enable_x64",
            suggestions=(
                "Call jax.config.update('jax_enable_x64', True) at startup",
                "Or request tolerance >= 3e-6 (the float32 tier)",
            ),
        )
    return x.astype(jnp.float64)


def max_levels(signal_length: int, wavelet) -> int:
    """Maximum decomposition depth: largest J with ``(L0-1)*2^(J-1)+1 <= N``,
    capped at :data:`MAX_DECOMPOSITION_LEVELS`
    (``MultiLevelMODWTTransform.calculateMaxLevels`` :455-501)."""
    w = _resolve_discrete(wavelet)
    filter_length = w.filter_length
    if signal_length <= filter_length:
        return 0
    level = 1
    while level < MAX_DECOMPOSITION_LEVELS:
        if effective_length(filter_length, level) > signal_length:
            break
        level += 1
    return level - 1


def _check_level_fits(w: DiscreteWavelet, level: int, n: int) -> None:
    if effective_length(w.filter_length, level) > n:
        raise InvalidArgumentError(
            ErrorCode.VAL_TOO_LARGE,
            "Upsampled filter length exceeds signal length",
            context={
                "wavelet": w.name,
                "level": level,
                "effective_filter_length": effective_length(w.filter_length, level),
                "signal_length": n,
            },
            suggestions=("Reduce decomposition levels or increase signal length",),
        )


_VALID_BACKENDS = (None, "auto", "jnp")


def _check_backend(backend: str | None) -> None:
    """Validate the ``backend`` argument.

    ``None``/``'auto'``/``'jnp'`` all select the XLA cascade (the
    reference's forceScalar analogue, TransformConfig.java:54, is kept as
    ``'jnp'``); anything else raises.
    """
    if backend not in _VALID_BACKENDS:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"Unknown backend {backend!r}",
            suggestions=("Use 'auto' or 'jnp' (or None)",),
        )


def modwt_multilevel(
    x: jnp.ndarray,
    wavelet,
    *,
    levels: int | None = None,
    boundary: str = "periodic",
    backend: str | None = None,
    tolerance: float | None = None,
    precision: str | None = None,
) -> MultiLevelMODWTResult:
    """Multi-level MODWT decomposition (``decompose`` :209-254).

    At level j the previous approximation is convolved with the base filters at
    stride ``2^(j-1)``, scaled ``1/sqrt(2)`` per stage.  ``backend`` accepts
    ``'auto'``/``'jnp'`` (the same XLA cascade) for compatibility.

    ``tolerance=`` requests a max-error budget and auto-routes the
    precision tier (:func:`resolve_tolerance`); ``precision=`` picks one
    explicitly (``float32 | exact``).  The ``exact`` tier upcasts the input
    and returns float64 planes whose round trip through
    :func:`imodwt_multilevel` stays <=1e-10 — the reference's default-path
    contract (ModwtPeriodicRoundTripTest.java:37).  It needs
    ``jax_enable_x64``.
    """
    _check_backend(backend)
    w = _resolve_discrete(wavelet)
    _validate_signal(x)
    n = x.shape[-1]
    if levels is None:
        levels = max_levels(n, w)
    if levels < 1:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_LEVEL,
            f"levels must be >= 1, got {levels}",
            context={"signal_length": n, "wavelet": w.name},
        )
    _check_level_fits(w, levels, n)
    if _resolve_tier(tolerance, precision) == "exact":
        x = _as_float64(x)

    low = w.dec_lo * _INV_SQRT2
    high = w.dec_hi * _INV_SQRT2
    use_fft = False
    if boundary.lower().startswith("per"):
        from ..ops.facade import should_use_fft

        use_fft = should_use_fft(n, w.filter_length)
    details = []
    current = x
    for level in range(1, levels + 1):
        spacing = 1 << (level - 1)
        if use_fft:
            from ..ops.convolve import fft_analysis_pair

            current, detail = fft_analysis_pair(
                current, low, high, spacing=spacing
            )
            details.append(detail)
            continue
        current, detail = atrous_analysis_pair(
            current, low, high, spacing=spacing, boundary=boundary
        )
        details.append(detail)
    return MultiLevelMODWTResult(tuple(details), current)


class _AlignmentDecision(NamedTuple):
    approx_plus: bool
    delta_approx: int
    detail_plus: bool
    delta_detail: int


#: Per-(wavelet, level) decisions derived by our own coordinate-descent sweep
#: (tools/derive_symmetric_alignment.py — the reference's sweep methodology,
#: MultiLevelMODWTSymmetricAlignmentSweepTest).  Seeded from the reference's
#: table and only accepted when strictly better, so quality dominates the
#: ported heuristic; deeper levels reuse the last entry.
_DERIVED_ALIGNMENT: dict[str, list[tuple[bool, int, bool, int]]] = {
    "haar": [(True, 0, True, 0), (True, -1, True, -1), (True, -1, True, -1), (True, -1, True, -1), (True, -1, False, -1)],
    "db2": [(False, -1, True, -1), (False, 0, False, -1), (False, 1, True, 1), (False, -1, False, -1), (False, 1, True, 1)],
    "db4": [(False, -1, True, 0), (False, -1, True, 1), (False, -1, True, 1), (True, 1, False, 1), (False, 1, False, 1)],
    "db6": [(True, 1, False, -1), (False, -1, True, -1), (False, -1, False, -1), (False, 1, False, -1), (False, -1, True, -1)],
    "db8": [(False, 1, True, 1), (False, 1, False, 1), (False, 1, False, 0), (True, 1, True, 1), (False, -1, True, 1)],
    "db10": [(False, -1, False, -1), (True, 1, True, 1), (False, -1, True, 1), (False, 1, True, -1), (False, 1, True, 1)],
    "sym4": [(False, 0, True, 0), (True, -1, True, -1), (True, 1, True, 1), (False, 1, False, -1), (False, 1, True, 1)],
    "sym8": [(True, 0, False, 1), (False, 1, False, 0), (False, 1, True, 0), (False, 1, True, -1), (True, -1, False, 1)],
    "sym12": [(False, 0, False, 1), (False, 1, True, -1), (False, 1, False, 1), (True, -1, True, -1), (False, 1, False, -1)],
    "coif2": [(True, 0, False, 0), (True, 1, False, 1), (True, 1, True, 0), (True, 1, False, -1), (True, -1, False, -1)],
    "coif3": [(False, 0, False, 1), (False, 1, True, 1), (False, -1, True, -1), (True, -1, False, -1), (True, -1, True, -1)],
    "coif5": [(False, 1, True, 1), (False, 1, False, 1), (True, 1, True, 1), (False, -1, True, 1), (False, -1, True, -1)],
    "bior2.2": [(True, 1, True, 1), (True, 0, True, 1), (True, 1, True, 0), (True, 0, True, -1), (True, -1, True, -1)],
    "bior4.4": [(True, 1, True, -1), (True, 1, True, 1), (True, 1, True, 1), (True, 1, True, 0), (True, -1, True, 0)],
}


def _symmetric_alignment(w: DiscreteWavelet, level: int) -> _AlignmentDecision:
    """Symmetric-inverse orientation decision.

    Prefers the sweep-derived per-level table (better interior NRMSE than the
    reference baselines); falls back to the reference's heuristic table for
    wavelets not yet swept (``SymmetricAlignmentStrategy.decide`` :44-120).
    """
    derived = _DERIVED_ALIGNMENT.get(w.name)
    if derived is not None:
        entry = derived[min(level, len(derived)) - 1]
        return _AlignmentDecision(*entry)
    base_len = w.rec_lo.shape[0]
    name = w.name

    if base_len <= 2:  # Haar
        return _AlignmentDecision(True, 0 if level <= 1 else -1, True, 0)

    if name == "db6":
        return _AlignmentDecision(
            False, 0 if level <= 1 else -1, True, 1 if level >= 3 else 0
        )
    if name == "db8":
        return _AlignmentDecision(
            False, 0 if level <= 1 else 1, True, 1 if level >= 2 else 0
        )
    if name == "sym4":
        return _AlignmentDecision(True, 0, False, 0)
    if name == "sym8":
        if level <= 1:
            return _AlignmentDecision(False, 0, True, 0)
        if level == 2:
            return _AlignmentDecision(False, 1, True, 0)
        return _AlignmentDecision(False, 1, True, 1)
    if name == "coif2":
        return _AlignmentDecision(True, 0 if level <= 1 else 1, False, 0)
    if name == "coif3":
        if level <= 1:
            return _AlignmentDecision(False, 0, False, 0)
        return _AlignmentDecision(False, -1, False, 1)
    if base_len >= 12:
        if level <= 1:
            return _AlignmentDecision(False, 0, True, 0)
        even = level % 2 == 0
        delta = 0 if even else -1
        return _AlignmentDecision(False, delta, True, delta)
    # DB4-length families (L0 = 8)
    if level <= 1:
        return _AlignmentDecision(False, 0, True, 0)
    return _AlignmentDecision(False, -1, True, 0)


def _tau_j(base_filter_length: int, level: int) -> int:
    """Center offset of the level-j à trous filter
    (``MultiLevelMODWTTransform.computeTauJ`` :795-806)."""
    if level <= 1:
        return max(0, (base_filter_length - 1) // 2)
    return (effective_length(base_filter_length, level) - 1) // 2


def imodwt_multilevel(
    result: MultiLevelMODWTResult,
    wavelet,
    *,
    boundary: str = "periodic",
    backend: str | None = None,
    tolerance: float | None = None,
    precision: str | None = None,
) -> jnp.ndarray:
    """Multi-level MODWT reconstruction, coarsest to finest
    (``reconstruct`` :339-349 + ``applyScaledInverseMODWT`` :554-645).

    ``tolerance=``/``precision=`` requesting the exact tier need float64
    planes (from :func:`modwt_multilevel` with the same request): planes
    already rounded to float32 cannot meet a sub-float32 budget, and the
    alignment-shifted symmetric inverse is a boundary approximation, so
    both raise.
    """
    _check_backend(backend)
    w = _resolve_discrete(wavelet)
    if _resolve_tier(tolerance, precision) == "exact":
        if boundary.lower().startswith("sym"):
            raise InvalidArgumentError(
                ErrorCode.CFG_UNSUPPORTED_BOUNDARY,
                "The exact tier has no symmetric inverse: the "
                "alignment-shifted symmetric inverse is a boundary "
                "approximation by design (docs/API.md, "
                "MultiLevelMODWTTransform.java:602-642)",
                suggestions=("Use periodic/zero boundaries for the exact "
                             "round trip",),
            )
        if result.approx.dtype != jnp.float64:
            raise InvalidArgumentError(
                ErrorCode.CFG_INVALID_CONFIG,
                "tolerance/precision requests the exact tier, but this "
                "result carries float32 planes (the analysis already "
                "rounded them)",
                suggestions=("Run modwt_multilevel with the same tolerance=/"
                             "precision= so it returns float64 planes",),
            )
    low = w.rec_lo * _INV_SQRT2
    high = w.rec_hi * _INV_SQRT2
    boundary_l = boundary.lower()
    current = result.approx
    for level in range(result.levels, 0, -1):
        detail = result.details[level - 1]
        spacing = 1 << (level - 1)
        _check_level_fits(w, level, current.shape[-1])
        if boundary_l.startswith("sym"):
            dec = _symmetric_alignment(w, level)
            tau_h = _tau_j(w.rec_lo.shape[0], level) + dec.delta_approx
            tau_g = _tau_j(w.rec_hi.shape[0], level) + dec.delta_detail
            rec_a = atrous_convolve(
                current, low, spacing=spacing, boundary="symmetric",
                sign=+1 if dec.approx_plus else -1,
                offset=-tau_h if dec.approx_plus else tau_h,
            )
            rec_d = atrous_convolve(
                detail, high, spacing=spacing, boundary="symmetric",
                sign=+1 if dec.detail_plus else -1,
                offset=-tau_g if dec.detail_plus else tau_g,
            )
        else:
            rec_a = atrous_convolve(
                current, low, spacing=spacing, boundary=boundary, sign=+1
            )
            rec_d = atrous_convolve(
                detail, high, spacing=spacing, boundary=boundary, sign=+1
            )
        current = rec_a + rec_d
    return current

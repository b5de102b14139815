"""Lifting-scheme DWT: in-place polyphase factorization + lossless integer mode.

Beyond the reference's scope (VectorWave is convolution-only); lifting is the
second classical realisation of the fast wavelet transform (Daubechies &
Sweldens 1998, "Factoring wavelet transforms into lifting steps") and the one
JPEG2000 standardised.  It earns its place here for two reasons:

* **reversible integer-to-integer transforms** — each lifting step rounds its
  prediction before adding it, so the inverse subtracts the *identical*
  rounded value and the round trip is bit-exact on integer data regardless of
  float precision.  That is the lossless-compression mode (JPEG2000 5/3) a
  convolution DWT cannot provide.
* **fewer flops / a different fusion shape** — the polyphase split halves the
  working length and each step is a 1-2 tap shifted add on the half-rate
  grid, which XLA fuses into one elementwise pass per step.

Mapping: the polyphase split is a strided slice (``x[..., ::2]``), every
lifting step is ``jnp.roll`` + multiply-add on ``[..., N/2]`` lanes, and the
whole cascade is a fixed unrolled sequence — static shapes, no gather.
Boundaries are PERIODIC (the lifting analogue of the engine's exact mode);
other modes raise, mirroring :mod:`..ops.dwt`'s contract.

Schemes are data (:class:`LiftingScheme`), not code: Haar, LeGall 5/3
(JPEG2000 reversible), CDF 9/7 (JPEG2000 irreversible; equals the registry's
``bior4.4`` pair) and the Daubechies-Sweldens D4 factorization of ``db2``.
Normalisation constants are derived numerically from the step cascade's
DC/Nyquist gains rather than hardcoded, so every scheme lands on the engine's
``sum dec_lo = sqrt(2)`` convention and :func:`lifting_dwt` agrees with
:func:`..ops.dwt.dwt` up to a circular shift (tests prove this per scheme).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..errors import ErrorCode, InvalidArgumentError
from ..ops.dwt import DWTResult, WavedecResult, _check_even


class LiftingStep(NamedTuple):
    """One predict/update step: target += sum_k taps[k] * source[n + offsets[k]].

    ``kind='predict'`` lifts the odd phase from the even phase (detail
    prediction); ``kind='update'`` lifts the even phase from the odd phase.
    Offsets index the half-rate grid with periodic wrap.
    """

    kind: str
    taps: tuple[float, ...]
    offsets: tuple[int, ...]


class LiftingScheme(NamedTuple):
    """An ordered lifting cascade plus final branch normalisations."""

    name: str
    steps: tuple[LiftingStep, ...]
    k_approx: float
    k_detail: float


def _branch_gains(steps: tuple[LiftingStep, ...]) -> tuple[float, float]:
    """Unscaled cascade gains: approx branch at DC, detail branch at Nyquist.

    A constant signal has constant polyphase components, and lifting steps
    map constants to constants, so both probes reduce to scalar recursions.
    The engine's filters are normalised to |H(0)| = |G(pi)| = sqrt(2) (true
    for orthonormal families by construction and for the CDF pairs by the
    ``sum dec_lo = sum rec_lo = sqrt(2)`` convention), which pins k_approx
    and k_detail including sign.
    """

    def run(even: float, odd: float) -> tuple[float, float]:
        for step in steps:
            lift = sum(step.taps) * (even if step.kind == "predict" else odd)
            if step.kind == "predict":
                odd += lift
            else:
                even += lift
        return even, odd

    a_dc, _ = run(1.0, 1.0)  # x = 1: even = odd = 1
    _, d_ny = run(1.0, -1.0)  # x = (-1)^n: even = +1, odd = -1
    if abs(a_dc) < 1e-12 or abs(d_ny) < 1e-12:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            "Degenerate lifting cascade: zero DC (approx) or Nyquist (detail) gain",
        )
    return math.sqrt(2.0) / a_dc, math.sqrt(2.0) / d_ny


def _scheme(name: str, *steps: LiftingStep) -> LiftingScheme:
    k_a, k_d = _branch_gains(steps)
    return LiftingScheme(name, steps, k_a, k_d)


_SQRT3 = math.sqrt(3.0)

# CDF 9/7 lifting constants (Daubechies & Sweldens 1998, table 5; the JPEG2000
# Part-1 irreversible transform).
_CDF97_ALPHA = -1.5861343420693648
_CDF97_BETA = -0.0529801185718856
_CDF97_GAMMA = 0.8829110755411875
_CDF97_DELTA = 0.4435068520511142

LIFTING_SCHEMES: dict[str, LiftingScheme] = {
    s.name: s
    for s in (
        _scheme(
            "haar",
            LiftingStep("predict", (-1.0,), (0,)),
            LiftingStep("update", (0.5,), (0,)),
        ),
        _scheme(
            "legall53",
            LiftingStep("predict", (-0.5, -0.5), (0, 1)),
            LiftingStep("update", (0.25, 0.25), (-1, 0)),
        ),
        _scheme(
            "cdf97",
            LiftingStep("predict", (_CDF97_ALPHA, _CDF97_ALPHA), (0, 1)),
            LiftingStep("update", (_CDF97_BETA, _CDF97_BETA), (-1, 0)),
            LiftingStep("predict", (_CDF97_GAMMA, _CDF97_GAMMA), (0, 1)),
            LiftingStep("update", (_CDF97_DELTA, _CDF97_DELTA), (-1, 0)),
        ),
        # Daubechies-Sweldens D4 factorization (1998, section 7.5).
        _scheme(
            "db2",
            LiftingStep("update", (_SQRT3,), (0,)),
            LiftingStep("predict", (-_SQRT3 / 4.0, -(_SQRT3 - 2.0) / 4.0), (0, -1)),
            LiftingStep("update", (-1.0,), (1,)),
        ),
    )
}

_ALIASES = {"bior2.2": "legall53", "bior4.4": "cdf97", "jpeg2000": "cdf97"}


def get_lifting_scheme(scheme) -> LiftingScheme:
    """Resolve a scheme by name (``haar``/``legall53``/``cdf97``/``db2`` or a
    JPEG2000/bior alias) or pass a :class:`LiftingScheme` through."""
    if isinstance(scheme, LiftingScheme):
        return scheme
    key = str(scheme).lower()
    key = _ALIASES.get(key, key)
    found = LIFTING_SCHEMES.get(key)
    if found is None:
        raise InvalidArgumentError(
            ErrorCode.CFG_UNSUPPORTED_WAVELET,
            f"Unknown lifting scheme '{scheme}'",
            suggestions=(
                "One of: " + ", ".join(sorted(set(LIFTING_SCHEMES) | set(_ALIASES))),
            ),
        )
    return found


def _check_periodic(boundary: str) -> None:
    if boundary != "periodic":
        raise InvalidArgumentError(
            ErrorCode.CFG_UNSUPPORTED_BOUNDARY,
            f"Lifting transforms are periodic-only, got boundary='{boundary}'",
            suggestions=("Use boundary='periodic'",),
        )


def _step_sum(src: jnp.ndarray, step: LiftingStep) -> jnp.ndarray:
    out = None
    for tap, off in zip(step.taps, step.offsets):
        term = (jnp.roll(src, -off, axis=-1) if off else src) * tap
        out = term if out is None else out + term
    assert out is not None
    return out


def lifting_dwt(
    x: jnp.ndarray, scheme="cdf97", *, boundary: str = "periodic"
) -> DWTResult:
    """Single-level DWT via lifting (float path, normalised branches)."""
    _check_periodic(boundary)
    s = get_lifting_scheme(scheme)
    _check_even(x.shape[-1])
    even, odd = x[..., ::2], x[..., 1::2]
    for step in s.steps:
        if step.kind == "predict":
            odd = odd + _step_sum(even, step)
        else:
            even = even + _step_sum(odd, step)
    return DWTResult(even * s.k_approx, odd * s.k_detail)


def lifting_idwt(
    approx: jnp.ndarray,
    detail: jnp.ndarray,
    scheme="cdf97",
    *,
    boundary: str = "periodic",
) -> jnp.ndarray:
    """Exact inverse: undo scaling, run the steps backwards with signs flipped."""
    _check_periodic(boundary)
    s = get_lifting_scheme(scheme)
    even = approx / s.k_approx
    odd = detail / s.k_detail
    for step in reversed(s.steps):
        if step.kind == "predict":
            odd = odd - _step_sum(even, step)
        else:
            even = even - _step_sum(odd, step)
    out = jnp.stack([even, odd], axis=-1)
    return out.reshape(out.shape[:-2] + (2 * even.shape[-1],))


def _lift_rounded(src: jnp.ndarray, step: LiftingStep) -> jnp.ndarray:
    """floor(prediction + 1/2) in float, cast back to the integer dtype.

    Forward adds and inverse subtracts the SAME expression of the same
    operand, so reversibility is exact whatever the float precision.
    """
    f = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    pred = _step_sum(src.astype(f), step)
    return jnp.floor(pred + 0.5).astype(src.dtype)


def lifting_dwt_int(x: jnp.ndarray, scheme="legall53") -> DWTResult:
    """Reversible integer-to-integer DWT (JPEG2000 lossless mode).

    Input must be an integer array; branches are UNNORMALISED (no k scaling —
    scaling would break integer reversibility), matching the JPEG2000
    reversible 5/3 convention.  Round trip with :func:`lifting_idwt_int` is
    bit-exact.
    """
    if not jnp.issubdtype(x.dtype, jnp.integer):
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"lifting_dwt_int needs an integer array, got dtype {x.dtype}",
            suggestions=("Cast to int32, or use lifting_dwt for float data",),
        )
    s = get_lifting_scheme(scheme)
    _check_even(x.shape[-1])
    even, odd = x[..., ::2], x[..., 1::2]
    for step in s.steps:
        if step.kind == "predict":
            odd = odd + _lift_rounded(even, step)
        else:
            even = even + _lift_rounded(odd, step)
    return DWTResult(even, odd)


def lifting_idwt_int(
    approx: jnp.ndarray, detail: jnp.ndarray, scheme="legall53"
) -> jnp.ndarray:
    """Bit-exact inverse of :func:`lifting_dwt_int`."""
    s = get_lifting_scheme(scheme)
    even, odd = approx, detail
    for step in reversed(s.steps):
        if step.kind == "predict":
            odd = odd - _lift_rounded(even, step)
        else:
            even = even - _lift_rounded(odd, step)
    out = jnp.stack([even, odd], axis=-1)
    return out.reshape(out.shape[:-2] + (2 * even.shape[-1],))


def _check_levels(n: int, levels: int | None) -> int:
    if levels is None:
        levels = 0
        m = n
        while m % 2 == 0 and m >= 4:
            m //= 2
            levels += 1
    if levels < 1:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_LEVEL,
            f"levels must be >= 1, got {levels}",
            context={"signal_length": n},
        )
    if n % (1 << levels) != 0:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"Signal length {n} must be divisible by 2^levels = {1 << levels}",
            suggestions=("Reduce levels or pad the signal",),
        )
    return levels


def lifting_wavedec(
    x: jnp.ndarray, scheme="cdf97", *, levels: int | None = None
) -> WavedecResult:
    """Multi-level lifting decomposition (pyramid on the approx branch)."""
    levels = _check_levels(x.shape[-1], levels)
    details = []
    current = x
    for _ in range(levels):
        res = lifting_dwt(current, scheme)
        details.append(res.detail)
        current = res.approx
    return WavedecResult(tuple(details), current)


def lifting_waverec(result: WavedecResult, scheme="cdf97") -> jnp.ndarray:
    """Inverse of :func:`lifting_wavedec`."""
    current = result.approx
    for level in range(result.levels, 0, -1):
        current = lifting_idwt(current, result.details[level - 1], scheme)
    return current


def lifting_wavedec_int(
    x: jnp.ndarray, scheme="legall53", *, levels: int | None = None
) -> WavedecResult:
    """Multi-level reversible integer decomposition (lossless pyramid)."""
    levels = _check_levels(x.shape[-1], levels)
    details = []
    current = x
    for _ in range(levels):
        res = lifting_dwt_int(current, scheme)
        details.append(res.detail)
        current = res.approx
    return WavedecResult(tuple(details), current)


def lifting_waverec_int(result: WavedecResult, scheme="legall53") -> jnp.ndarray:
    """Bit-exact inverse of :func:`lifting_wavedec_int`."""
    current = result.approx
    for level in range(result.levels, 0, -1):
        current = lifting_idwt_int(current, result.details[level - 1], scheme)
    return current


def effective_filters(scheme, n: int = 64) -> tuple[np.ndarray, np.ndarray]:
    """Length-``n`` circular rows of the equivalent analysis filters.

    Row ``m`` of the returned pair satisfies ``approx[i] = sum_j lo[(j - 2i)
    mod n] * x[j]`` (and likewise for ``hi``), i.e. the same indexing as
    :func:`..ops.dwt.dwt`'s ``out[i] = sum_j f[j] x[(2i + j) mod N]`` read at
    ``i = 0``.  Used by the tests to prove lifting/convolution equivalence.
    """
    s = get_lifting_scheme(scheme)
    eye = jnp.eye(n, dtype=jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
    res = lifting_dwt(eye, s)  # rows = basis vectors
    lo = np.asarray(res.approx)[:, 0]  # approx[0] as a function of input index
    hi = np.asarray(res.detail)[:, 0]
    return lo, hi

"""Stationary Wavelet Transform (SWT) facade over the MODWT.

Re-design of the reference's ``VectorWaveSwtAdapter``
(``/root/reference/vectorwave-core/.../wavelet/swt/VectorWaveSwtAdapter.java:89-686``):
the SWT is the same undecimated cascade as the multi-level MODWT, exposed with
SWT conventions.  The adapter's *mutable* coefficient workflow
(``MutableMultiLevelMODWTResult``: threshold in place, zero levels, clear
caches) becomes functional pytree editing — each operation returns a new
coefficient set, which is the jit/grad-friendly formulation.

The reference's internal parallel path (chunking one signal's output range
across an executor when N >= 4096, ``VectorWaveSwtAdapter.java:210-240``) is
replaced by XLA's native vectorization and, across chips, by the sharded
transforms in ``vectorwave_tpu.parallel``.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..ops.thresholds import apply_threshold, mad_sigma, universal_threshold
from ..transforms.multilevel import (
    MultiLevelMODWTResult,
    imodwt_multilevel,
    modwt_multilevel,
)

#: SWT coefficients are identical to multi-level MODWT coefficients.
SWTResult = MultiLevelMODWTResult


def swt(
    x: jnp.ndarray,
    wavelet,
    *,
    levels: int | None = None,
    boundary: str = "periodic",
) -> SWTResult:
    """Forward SWT (``VectorWaveSwtAdapter.forward`` :184-205)."""
    return modwt_multilevel(x, wavelet, levels=levels, boundary=boundary)


def iswt(
    result: SWTResult,
    wavelet,
    *,
    boundary: str = "periodic",
) -> jnp.ndarray:
    """Inverse SWT (``VectorWaveSwtAdapter.inverse`` :435)."""
    return imodwt_multilevel(result, wavelet, boundary=boundary)


def threshold_level(
    result: SWTResult,
    level: int,
    threshold,
    *,
    mode: str = "soft",
) -> SWTResult:
    """Threshold one detail level (``applyThreshold`` :489-493), functionally."""
    details = list(result.details)
    details[level - 1] = apply_threshold(details[level - 1], threshold, mode)
    return SWTResult(tuple(details), result.approx)


def apply_universal_threshold(result: SWTResult, *, mode: str = "soft") -> SWTResult:
    """Universal threshold on every detail level, sigma from the finest level
    (``applyUniversalThreshold`` :505-519)."""
    sigma = mad_sigma(result.details[0])
    threshold = universal_threshold(result.signal_length, sigma)
    details = tuple(apply_threshold(d, threshold, mode) for d in result.details)
    return SWTResult(details, result.approx)


def swt_denoise(
    x: jnp.ndarray,
    wavelet,
    *,
    levels: int | None = None,
    threshold: float | None = None,
    mode: str = "soft",
    boundary: str = "periodic",
) -> jnp.ndarray:
    """Decompose, threshold, reconstruct (``denoise`` :532-563).

    ``threshold=None`` selects the universal threshold (the reference encodes
    this as a negative threshold argument).
    """
    result = swt(x, wavelet, levels=levels, boundary=boundary)
    if threshold is None or (isinstance(threshold, (int, float)) and threshold < 0):
        result = apply_universal_threshold(result, mode=mode)
    else:
        details = tuple(apply_threshold(d, threshold, mode) for d in result.details)
        result = SWTResult(details, result.approx)
    return iswt(result, wavelet, boundary=boundary)


def extract_level(
    x: jnp.ndarray,
    wavelet,
    levels: int,
    target_level: int,
    *,
    boundary: str = "periodic",
) -> jnp.ndarray:
    """Band isolation: zero all levels but ``target_level`` and reconstruct
    (``extractLevel`` :576-619; 0 selects the approximation band)."""
    if not (0 <= target_level <= levels):
        from ..errors import ErrorCode, InvalidArgumentError

        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_LEVEL,
            f"target_level must be in [0, {levels}], got {target_level}",
        )
    result = swt(x, wavelet, levels=levels, boundary=boundary)
    details = tuple(
        d if level == target_level else jnp.zeros_like(d)
        for level, d in enumerate(result.details, start=1)
    )
    approx = result.approx if target_level == 0 else jnp.zeros_like(result.approx)
    return iswt(SWTResult(details, approx), wavelet, boundary=boundary)


def mra(
    x: jnp.ndarray,
    wavelet,
    *,
    levels: int | None = None,
    boundary: str = "periodic",
) -> tuple[jnp.ndarray, ...]:
    """Multi-resolution analysis: additive per-band reconstructions
    (details 1..J then the smooth), summing exactly to the signal under
    PERIODIC boundaries.  Convenience composition of :func:`extract_level`
    sharing one decomposition.
    """
    result = swt(x, wavelet, levels=levels, boundary=boundary)
    bands = []
    zero = jnp.zeros_like(result.approx)
    for level in range(1, result.levels + 1):
        details = tuple(
            d if j == level else jnp.zeros_like(d)
            for j, d in enumerate(result.details, start=1)
        )
        bands.append(iswt(SWTResult(details, zero), wavelet, boundary=boundary))
    smooth = iswt(
        SWTResult(tuple(jnp.zeros_like(d) for d in result.details), result.approx),
        wavelet,
        boundary=boundary,
    )
    bands.append(smooth)
    return tuple(bands)

"""2-D Stationary Wavelet Transform facade over the 2-D MODWT.

The 2-D analogue of :mod:`.swt` (the reference's ``VectorWaveSwtAdapter``
is 1-D only — ``vectorwave-core/.../swt/VectorWaveSwtAdapter.java:89-686``;
this extends its conventions to images the way ``pywt.swt2`` extends
``pywt.swt``).  Coefficients are identical to :func:`.twodim.
modwt2_multilevel`'s, so everything here is functional pytree editing over
that engine.
"""

from __future__ import annotations

import jax.numpy as jnp

from .twodim import (
    MultiLevelMODWT2Result,
    denoise2,
    imodwt2_multilevel,
    modwt2_multilevel,
)

__all__ = [
    "SWT2Result",
    "swt2",
    "iswt2",
    "swt2_denoise",
    "extract_level2",
    "mra2",
]

#: 2-D SWT coefficients are identical to multi-level 2-D MODWT coefficients.
SWT2Result = MultiLevelMODWT2Result


def swt2(
    x: jnp.ndarray,
    wavelet,
    *,
    levels: int,
    boundary: str = "periodic",
) -> SWT2Result:
    """Forward 2-D SWT (undecimated; per-level (lh, hl, hh) + final ll)."""
    return modwt2_multilevel(x, wavelet, levels=levels, boundary=boundary)


def iswt2(
    result: SWT2Result,
    wavelet,
    *,
    boundary: str = "periodic",
) -> jnp.ndarray:
    """Inverse 2-D SWT (exact reconstruction under periodic boundaries)."""
    return imodwt2_multilevel(result, wavelet, boundary=boundary)


def swt2_denoise(
    x: jnp.ndarray,
    wavelet,
    *,
    levels: int = 3,
    method: str = "universal",
    mode: str = "soft",
    boundary: str = "periodic",
) -> jnp.ndarray:
    """Shift-invariant 2-D denoising in SWT terms (see
    :func:`.twodim.denoise2` — sigma from the finest diagonal band)."""
    return denoise2(
        x, wavelet, levels=levels, method=method, mode=mode,
        boundary=boundary,
    )


def extract_level2(
    x: jnp.ndarray,
    wavelet,
    levels: int,
    target_level: int,
    *,
    boundary: str = "periodic",
) -> jnp.ndarray:
    """Band isolation: zero all subbands except ``target_level``'s three
    orientation bands and reconstruct (0 selects the smooth/ll band)."""
    if not (0 <= target_level <= levels):
        from ..errors import ErrorCode, InvalidArgumentError

        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_LEVEL,
            f"target_level must be in [0, {levels}], got {target_level}",
        )
    result = swt2(x, wavelet, levels=levels, boundary=boundary)
    details = tuple(
        trip if level == target_level
        else tuple(jnp.zeros_like(p) for p in trip)
        for level, trip in enumerate(result.details, start=1)
    )
    approx = (
        result.approx if target_level == 0 else jnp.zeros_like(result.approx)
    )
    return iswt2(SWT2Result(details, approx), wavelet, boundary=boundary)


def mra2(
    x: jnp.ndarray,
    wavelet,
    *,
    levels: int,
    boundary: str = "periodic",
) -> tuple[jnp.ndarray, ...]:
    """2-D multi-resolution analysis: additive per-scale reconstructions
    (detail images 1..J then the smooth), summing exactly to the image
    under PERIODIC boundaries.  One decomposition shared by all bands."""
    result = swt2(x, wavelet, levels=levels, boundary=boundary)
    zeros = tuple(
        tuple(jnp.zeros_like(p) for p in trip) for trip in result.details
    )
    zero_ll = jnp.zeros_like(result.approx)
    bands = []
    for level in range(1, levels + 1):
        details = tuple(
            result.details[j - 1] if j == level else zeros[j - 1]
            for j in range(1, levels + 1)
        )
        bands.append(
            iswt2(SWT2Result(details, zero_ll), wavelet, boundary=boundary)
        )
    bands.append(
        iswt2(SWT2Result(zeros, result.approx), wavelet, boundary=boundary)
    )
    return tuple(bands)

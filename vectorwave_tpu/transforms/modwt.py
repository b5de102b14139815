"""Single-level MODWT forward/inverse.

Re-design of ``MODWTTransform``
(``/root/reference/vectorwave-core/.../wavelet/modwt/MODWTTransform.java:131-296``):
pure jittable functions over ``[..., N]`` arrays instead of a stateful transform
object.  Filters are scaled by 1/sqrt(2) (the MODWT shift-invariance scaling,
``MODWTTransform.java:141-150``) and baked in at trace time.

Batch processing (the reference's ``forwardBatch``/``inverseBatch``
:486-559 and the extensions' ``BatchMODWT`` facade) is just leading batch axes
here — arrays are natively "SoA", and sharding the batch axis over a mesh
replaces the SIMD lane packing.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax.numpy as jnp

from ..errors import ErrorCode, InvalidSignalError
from ..ops.convolve import atrous_analysis_pair, atrous_convolve
from ..wavelets.base import DiscreteWavelet
from ..wavelets.registry import as_wavelet

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


class MODWTResult(NamedTuple):
    """Single-level MODWT coefficients (reference: modwt/MODWTResult.java).

    Both fields have the same shape as the input signal (undecimated
    transform).  Being a NamedTuple it is automatically a JAX pytree.
    """

    approx: jnp.ndarray
    detail: jnp.ndarray

    @property
    def signal_length(self) -> int:
        return self.approx.shape[-1]

    def is_valid(self) -> jnp.ndarray:
        """Finite-coefficient check (MODWTResult.isValid)."""
        return jnp.isfinite(self.approx).all() & jnp.isfinite(self.detail).all()

    def energy(self) -> jnp.ndarray:
        return (self.approx**2).sum(axis=-1) + (self.detail**2).sum(axis=-1)


def _resolve_discrete(wavelet) -> DiscreteWavelet:
    w = as_wavelet(wavelet)
    if not isinstance(w, DiscreteWavelet):
        from ..errors import InvalidArgumentError

        raise InvalidArgumentError(
            ErrorCode.CFG_UNSUPPORTED_TRANSFORM,
            f"Wavelet {w.name!r} is continuous; MODWT requires a discrete wavelet",
            suggestions=("Use cwt() for continuous wavelets",),
        )
    return w


def _validate_signal(x: jnp.ndarray, min_length: int = 1) -> None:
    if x.ndim < 1 or x.shape[-1] < min_length:
        raise InvalidSignalError(
            ErrorCode.VAL_TOO_SHORT,
            f"Signal length {x.shape[-1] if x.ndim else 0} below minimum {min_length}",
            context={"shape": tuple(x.shape)},
        )


def modwt(
    x: jnp.ndarray,
    wavelet,
    *,
    boundary: str = "periodic",
) -> MODWTResult:
    """Single-level forward MODWT (``MODWTTransform.forward`` :131-188).

    Args:
      x: ``[..., N]`` real signal(s); any N >= 1 (no power-of-2 restriction).
      wavelet: registry name or :class:`DiscreteWavelet`.
      boundary: ``periodic`` (exact reconstruction), ``zero`` or ``symmetric``.

    Returns:
      :class:`MODWTResult` with same-shape approximation and detail arrays.
    """
    w = _resolve_discrete(wavelet)
    _validate_signal(x)
    low = w.dec_lo * _INV_SQRT2
    high = w.dec_hi * _INV_SQRT2
    if boundary.lower().startswith("per"):
        from ..ops.facade import should_use_fft

        if should_use_fft(x.shape[-1], w.filter_length):
            from ..ops.convolve import fft_analysis_pair

            approx, detail = fft_analysis_pair(x, low, high, spacing=1)
            return MODWTResult(approx, detail)
    approx, detail = atrous_analysis_pair(x, low, high, spacing=1, boundary=boundary)
    return MODWTResult(approx, detail)


def imodwt(
    result: MODWTResult | tuple[jnp.ndarray, jnp.ndarray],
    wavelet,
    *,
    boundary: str = "periodic",
) -> jnp.ndarray:
    """Single-level inverse MODWT (``MODWTTransform.inverse`` :195-296).

    Periodic/zero use adjoint ``(t+l)`` synthesis indexing; symmetric uses the
    reference's time-reversed ``(t-l)`` reconstruction with symmetric extension
    (``MODWTTransform.java:273-296``).
    """
    approx, detail = result
    w = _resolve_discrete(wavelet)
    low = w.rec_lo * _INV_SQRT2
    high = w.rec_hi * _INV_SQRT2
    sign = -1 if boundary.lower().startswith("sym") else +1
    rec_a = atrous_convolve(approx, low, spacing=1, boundary=boundary, sign=sign)
    rec_d = atrous_convolve(detail, high, spacing=1, boundary=boundary, sign=sign)
    return rec_a + rec_d

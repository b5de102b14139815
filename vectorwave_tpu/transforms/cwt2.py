"""2-D continuous wavelet transform: scales x orientations.

Extends the 1-D CWT engine (``transforms/cwt.py``, reference
``CWTTransform.java``) to images — the analysis the reference's 2-D-free API
cannot do: directional texture/edge analysis over a scale-angle grid.

Design (all frequency domain):

* a wavelet is *defined by its 2-D spectrum* ``psi_hat(kx, ky)`` (angular
  frequency, radians/sample).  The scale-``s``, angle-``theta`` filter is
  ``s * psi_hat(s * R_{-theta} k)`` — L2-normalized by construction, so
  coefficient magnitudes are comparable across scales.
* ``cwt2`` computes ONE ``fft2`` of the image, multiplies the
  ``[S, A, H, W]`` bank (built on device from the formula — nothing is
  tabulated), and batch-``ifft2``s back.  Real isotropic wavelets ride the
  half-spectrum ``rfft2`` path.
* ``icwt2`` inverts by least squares in the frequency domain:
  ``x_hat = sum(conj(g) c) / sum(|g|^2)`` wherever the bank covers the
  spectrum (the 2-D analogue of the 1-D ``icwt`` equalized mode) — exact up
  to the uncovered tails (DC is never covered: reconstructions are
  zero-mean; pass ``mean`` to restore it).

Memory: the coefficient field is ``[..., S, A, H, W]`` — choose the
scale/angle grid to fit HBM (64 scales x 8 angles x 1024^2 complex64 is
~4 GB).  Scales/angles are a leading axis: shard or ``lax.map`` over them
for bigger grids.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Sequence

import numpy as np
import jax.numpy as jnp

from ..errors import (
    ErrorCode,
    InvalidArgumentError,
    InvalidSignalError,
)

__all__ = [
    "ContinuousWavelet2D",
    "CWT2Result",
    "morlet2",
    "mexican_hat2",
    "gaussian2",
    "cwt2",
    "icwt2",
    "scale_to_frequency2",
    "scales_for_frequencies2",
]


def _xp(a):
    """Array namespace of ``a`` (host numpy vs device/traced jax)."""
    return jnp if isinstance(a, jnp.ndarray) else np


class ContinuousWavelet2D(NamedTuple):
    """A 2-D continuous wavelet, defined by its spectrum.

    ``psi_hat(kx, ky)`` maps angular-frequency grids to the (unnormalized)
    spectrum; implementations dispatch on the input type (``_xp``) so the
    same formula runs host-side (normalization) and on device/under jit
    (bank construction).
    """

    name: str
    psi_hat: Callable
    is_complex: bool  # one-sided spectrum -> complex coefficients
    isotropic: bool  # rotation has no effect; angles must be (0,)
    peak_freq: float  # |k| at the scale-1 spectral peak (radians/sample)


def _l2_norm(w: ContinuousWavelet2D) -> float:
    """||psi||_2 at scale 1 from the spectrum (Parseval), on a host grid."""
    k = np.linspace(-np.pi * 8, np.pi * 8, 2048, dtype=np.float64)
    kx, ky = np.meshgrid(k, k, indexing="ij")
    vals = np.abs(np.asarray(w.psi_hat(kx, ky))) ** 2
    dk = k[1] - k[0]
    return float(np.sqrt(vals.sum() * dk * dk) / (2.0 * math.pi))


def morlet2(omega0: float = 5.336, aniso: float = 1.0) -> ContinuousWavelet2D:
    """2-D Morlet: a Gaussian envelope around the carrier ``(omega0, 0)``.

    ``aniso > 1`` narrows the envelope across the carrier direction
    (sharper orientation selectivity).  ``omega0 >= 5`` keeps the
    admissibility correction below 1e-5 (omitted, as in the 1-D family).
    """
    if omega0 < 2.0:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"morlet2 needs omega0 >= 2 (admissibility), got {omega0}",
        )

    def psi_hat(kx, ky):
        return _xp(kx).exp(-0.5 * ((kx - omega0) ** 2 + (aniso * ky) ** 2))

    return ContinuousWavelet2D(
        f"morl2-{omega0:g}", psi_hat, True, False, float(omega0)
    )


def mexican_hat2() -> ContinuousWavelet2D:
    """Isotropic 2-D Mexican hat (negative Laplacian of Gaussian):
    ``psi_hat = |k|^2 exp(-|k|^2 / 2)``; real coefficients, blob detector."""

    def psi_hat(kx, ky):
        k2 = kx * kx + ky * ky
        return k2 * _xp(kx).exp(-0.5 * k2)

    return ContinuousWavelet2D("mexh2", psi_hat, False, True, math.sqrt(2.0))


def gaussian2(order: int = 2, *, directional: bool = False) -> ContinuousWavelet2D:
    """Gaussian-derivative family.

    ``directional=False``: isotropic ``|k|^m exp(-|k|^2/2)`` (order-m radial
    ridge detector; real).  ``directional=True``: ``(i kx)^m exp(-|k|^2/2)``
    — the m-th derivative along the (rotated) x axis; complex for odd m,
    orientation-selective for all m.
    """
    if order < 1:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG, f"order must be >= 1, got {order}"
        )
    if directional:

        def psi_hat(kx, ky):
            return (1j * kx) ** order * _xp(kx).exp(-0.5 * (kx * kx + ky * ky))

        is_complex = True
        iso = False
    else:

        def psi_hat(kx, ky):
            k2 = kx * kx + ky * ky
            return k2 ** (order / 2.0) * _xp(kx).exp(-0.5 * k2)

        is_complex = False
        iso = True
    return ContinuousWavelet2D(
        f"gaus2-{order}{'d' if directional else ''}",
        psi_hat,
        is_complex,
        iso,
        math.sqrt(float(order)),
    )


_NAMED = {
    "morl2": morlet2,
    "mexh2": mexican_hat2,
    "gaus2": gaussian2,
}


def _resolve_2d(wavelet) -> ContinuousWavelet2D:
    if isinstance(wavelet, ContinuousWavelet2D):
        return wavelet
    if isinstance(wavelet, str):
        key = wavelet.lower()
        if key in _NAMED:
            return _NAMED[key]()
        raise InvalidArgumentError(
            ErrorCode.CFG_UNSUPPORTED_WAVELET,
            f"Unknown 2-D wavelet {wavelet!r}",
            suggestions=(f"Use one of {sorted(_NAMED)} or a "
                         "ContinuousWavelet2D instance",),
        )
    raise InvalidArgumentError(
        ErrorCode.CFG_UNSUPPORTED_WAVELET,
        f"Expected a name or ContinuousWavelet2D, got {type(wavelet).__name__}",
    )


def scale_to_frequency2(wavelet, scale: float) -> float:
    """Radial frequency (cycles/sample) the given scale responds to most."""
    w = _resolve_2d(wavelet)
    return w.peak_freq / (2.0 * math.pi * float(scale))


def scales_for_frequencies2(wavelet, freqs: Sequence[float]) -> tuple[float, ...]:
    """Scales whose spectral peaks sit at the given radial frequencies."""
    w = _resolve_2d(wavelet)
    out = []
    for f in freqs:
        if f <= 0:
            raise InvalidArgumentError(
                ErrorCode.CFG_INVALID_CONFIG, f"frequency must be > 0, got {f}"
            )
        out.append(w.peak_freq / (2.0 * math.pi * float(f)))
    return tuple(out)


class CWT2Result(NamedTuple):
    """Coefficients ``[..., S, A, H, W]`` plus the analysis grid."""

    coeffs: jnp.ndarray
    scales: tuple[float, ...]
    angles: tuple[float, ...]
    boundary: str

    def magnitude(self) -> jnp.ndarray:
        return jnp.abs(self.coeffs)

    def power(self) -> jnp.ndarray:
        return jnp.abs(self.coeffs) ** 2

    def scalogram(self) -> jnp.ndarray:
        """Total power per (scale, angle) cell: ``[..., S, A]``."""
        return jnp.sum(jnp.abs(self.coeffs) ** 2, axis=(-2, -1))

    def dominant_orientation(self) -> jnp.ndarray:
        """Per-pixel argmax angle over scales+angles: ``[..., H, W]``."""
        power = jnp.abs(self.coeffs) ** 2
        best_s = jnp.max(power, axis=-4)  # over scales -> [..., A, H, W]
        idx = jnp.argmax(best_s, axis=-3)
        ang = jnp.asarray(self.angles, dtype=jnp.float32)
        return ang[idx]


def _validate(scales, angles, w: ContinuousWavelet2D):
    scales = tuple(float(s) for s in np.atleast_1d(np.asarray(scales)))
    if len(scales) == 0:
        raise InvalidArgumentError(
            ErrorCode.VAL_EMPTY_SIGNAL, "scales must be non-empty"
        )
    if any(s <= 0 or not math.isfinite(s) for s in scales):
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG, f"scales must be positive finite: {scales}"
        )
    angles = tuple(float(a) for a in np.atleast_1d(np.asarray(angles)))
    if len(angles) == 0:
        raise InvalidArgumentError(
            ErrorCode.VAL_EMPTY_SIGNAL, "angles must be non-empty"
        )
    if w.isotropic and len(angles) > 1:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"{w.name} is isotropic: rotation is a no-op, use angles=(0.0,)",
            suggestions=("Pick a directional wavelet (morl2, gaus2 "
                         "directional) for orientation analysis",),
        )
    return scales, angles


def _freq_grids(fh: int, fw: int, real: bool, dtype):
    """Angular-frequency meshes for an ``fh x fw`` transform."""
    ky = 2.0 * jnp.pi * jnp.fft.fftfreq(fh).astype(dtype)
    if real:
        kx = 2.0 * jnp.pi * jnp.fft.rfftfreq(fw).astype(dtype)
    else:
        kx = 2.0 * jnp.pi * jnp.fft.fftfreq(fw).astype(dtype)
    return jnp.meshgrid(ky, kx, indexing="ij")  # [fh, fwk] each


def _bank(w, scales, angles, fh, fw, real, dtype):
    """Conjugate filter bank ``[S, A, fh, fwk]`` built on device."""
    kyg, kxg = _freq_grids(fh, fw, real, dtype)
    norm = _l2_norm(w)
    rows = []
    for s in scales:
        per_angle = []
        for theta in angles:
            c, sn = math.cos(theta), math.sin(theta)
            # rotate the frequency plane by -theta: k' = R_{-theta} k
            kxr = c * kxg + sn * kyg
            kyr = -sn * kxg + c * kyg
            g = w.psi_hat(s * kxr, s * kyr) * (s / norm)
            per_angle.append(jnp.conj(g))
        rows.append(jnp.stack(per_angle))
    return jnp.stack(rows)  # [S, A, fh, fwk]


def _fft_dims(h, wd, boundary, max_scale):
    if boundary == "periodic":
        return h, wd
    pad = int(math.ceil(5.0 * max_scale))
    return (
        1 << (h + 2 * pad - 1).bit_length(),
        1 << (wd + 2 * pad - 1).bit_length(),
    )


def cwt2(
    image: jnp.ndarray,
    scales: Sequence[float],
    wavelet="morl2",
    *,
    angles: Sequence[float] = (0.0,),
    boundary: str = "periodic",
) -> CWT2Result:
    """2-D CWT of ``[..., H, W]`` images over a scale x angle grid.

    ``boundary``: ``periodic`` (FFT-native) or ``zero`` (pad each dim to the
    next power of two past the largest filter support).  Returns
    :class:`CWT2Result` with coefficients ``[..., S, A, H, W]`` — complex
    for one-sided wavelets (morl2, directional gaus2), real for isotropic
    real ones (mexh2, radial gaus2).
    """
    w = _resolve_2d(wavelet)
    scales, angles = _validate(scales, angles, w)
    if image.ndim < 2:
        raise InvalidSignalError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"cwt2 expects [..., H, W], got shape {image.shape}",
        )
    h, wd = image.shape[-2], image.shape[-1]
    if h < 2 or wd < 2:
        raise InvalidSignalError(
            ErrorCode.VAL_TOO_SHORT, f"image {h}x{wd} below minimum 2x2"
        )
    if boundary not in ("periodic", "zero"):
        raise InvalidArgumentError(
            ErrorCode.CFG_UNSUPPORTED_BOUNDARY,
            f"cwt2 supports periodic/zero, got {boundary!r}",
        )
    fh, fw = _fft_dims(h, wd, boundary, max(scales))
    real_dtype = (
        image.dtype if jnp.issubdtype(image.dtype, jnp.floating) else jnp.float32
    )
    x = image.astype(real_dtype)
    use_real = not w.is_complex

    if use_real:
        spec = jnp.fft.rfft2(x, s=(fh, fw))
        bank = _bank(w, scales, angles, fh, fw, True, real_dtype)
        prod = spec[..., None, None, :, :] * bank
        out = jnp.fft.irfft2(prod, s=(fh, fw))[..., :h, :wd]
        out = out.astype(real_dtype)
    else:
        spec = jnp.fft.fft2(x, s=(fh, fw))
        bank = _bank(w, scales, angles, fh, fw, False, real_dtype)
        prod = spec[..., None, None, :, :] * bank
        out = jnp.fft.ifft2(prod)[..., :h, :wd]
    return CWT2Result(out, scales, angles, boundary)


def _reflect_spectrum(a: jnp.ndarray) -> jnp.ndarray:
    """``conj(A(-k))`` on an fft2 grid (the Hermitian-mirror spectrum)."""
    out = jnp.conj(a)
    for ax in (-2, -1):
        out = jnp.roll(jnp.flip(out, axis=ax), 1, axis=ax)
    return out


def icwt2(
    result: CWT2Result,
    wavelet="morl2",
    *,
    mean: float | jnp.ndarray = 0.0,
    floor: float = 1e-3,
) -> jnp.ndarray:
    """Least-squares inverse of :func:`cwt2`.

    Divides the bank-adjoint accumulation by the aggregate spectral response
    ``sum |g|^2`` wherever it exceeds ``floor * max`` (the 2-D analogue of
    the 1-D equalized ``icwt``; the division is exact, so the default floor
    is small — raise it only to suppress noise amplification at weakly
    covered frequencies).  Exact up to spectral regions the scale/angle grid
    does not cover (pick scales with :func:`scales_for_frequencies2`); DC is
    never covered — ``mean`` restores it.
    """
    w = _resolve_2d(wavelet)
    scales, angles = result.scales, result.angles
    coeffs = result.coeffs
    h, wd = coeffs.shape[-2], coeffs.shape[-1]
    # Invert on the crop grid with the periodic operator: for periodic
    # forward transforms this is the exact adjoint (machine-precision round
    # trips); for zero-boundary ones the cropped coefficients differ from
    # periodic ones near the borders, and the frequency-domain division
    # spreads that discrepancy (measured ~1e-2 relative interior, larger at
    # edges) — non-periodic round trips are approximate by design, as in
    # the 1-D transforms.
    fh, fw = h, wd
    real_out = not jnp.iscomplexobj(coeffs)
    real_dtype = coeffs.real.dtype if not real_out else coeffs.dtype

    bank = _bank(w, scales, angles, fh, fw, real_out, real_dtype)
    response = jnp.sum(jnp.abs(bank) ** 2, axis=(0, 1))  # [fh, fwk]
    cutoff = floor * jnp.max(response)
    inv = jnp.where(response > cutoff, 1.0 / jnp.maximum(response, cutoff), 0.0)

    if real_out:
        spec = jnp.fft.rfft2(coeffs, s=(fh, fw))
        acc = jnp.sum(jnp.conj(bank) * spec, axis=(-4, -3))
        out = jnp.fft.irfft2(acc * inv, s=(fh, fw))[..., :h, :wd]
        out = out.astype(real_dtype)
    else:
        spec = jnp.fft.fft2(coeffs, s=(fh, fw))
        acc = jnp.sum(jnp.conj(bank) * spec, axis=(-4, -3))
        # One-sided wavelets may cover each +-k pair once (angles in [0,pi))
        # or twice (angles spanning the full circle).  Combine the LS
        # estimate with its Hermitian reflection, weighted by which side(s)
        # the bank actually covered, so both layouts invert exactly.
        mask = (response > cutoff).astype(real_dtype)
        x_ls = acc * inv * mask
        x_ref = _reflect_spectrum(x_ls)
        m_ref = _reflect_spectrum(mask).real
        x_hat = (x_ls * mask + x_ref * m_ref) / jnp.maximum(mask + m_ref, 1.0)
        out = jnp.real(jnp.fft.ifft2(x_hat))[..., :h, :wd]
        out = out.astype(real_dtype)
    return out + mean

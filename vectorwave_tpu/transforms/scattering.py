"""Wavelet scattering transform (1-D): translation-invariant features.

Mallat's scattering network (Group Invariant Scattering, CPAM 2012;
the construction popularized by Kymatio — method reference only): cascade
of wavelet-modulus operators followed by a lowpass average,

    S0      = x * phi_J
    S1(l1)  = |x * psi_{l1}| * phi_J
    S2(l1,l2) = ||x * psi_{l1}| * psi_{l2}| * phi_J,  xi_{l2} < xi_{l1}

Locally translation invariant up to the averaging scale ``2^J``, stable to
small deformations, and — unlike a spectrogram — S2 captures amplitude-
modulation structure that survives the first modulus.  The classic
front-end for ML on audio/biomedical/financial series.

Formulation: the whole filterbank (Morlet band-passes, ``Q``
per octave, plus a Gaussian lowpass) is built ONCE in the frequency domain
at trace time; every order is a batched ``rfft``/``irfft`` product over a
stacked path axis, so the full network is a handful of large FFT+elementwise
ops — no per-path Python loops at run time beyond path enumeration.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from ..errors import ErrorCode, InvalidArgumentError, InvalidSignalError

__all__ = ["ScatteringResult", "scattering1d", "scattering_filterbank"]


class ScatteringResult(NamedTuple):
    """Scattering coefficients at stride ``2^J`` (time axis last).

    ``s1`` carries the path axis ``n1`` (one per first-order wavelet,
    highest frequency first); ``s2``'s paths are ``pairs`` (indices into
    the first/second-order banks).
    """

    s0: jnp.ndarray  # [..., T]
    s1: jnp.ndarray  # [..., n1, T]
    s2: jnp.ndarray | None  # [..., n2, T] or None for order-1
    xi1: tuple[float, ...]  # first-order center frequencies (cycles/sample)
    xi2: tuple[float, ...]  # second-order center frequencies
    pairs: tuple[tuple[int, int], ...]  # (i1, i2) path indices for s2

    def feature_vector(self) -> jnp.ndarray:
        """Time-averaged log features ``[..., 1 + n1 + n2]`` (the standard
        classification front-end)."""
        eps = 1e-8
        feats = [jnp.log(jnp.mean(self.s0, axis=-1, keepdims=True) ** 2 + eps)]
        feats.append(jnp.log(jnp.mean(self.s1, axis=-1) + eps))
        if self.s2 is not None:
            feats.append(jnp.log(jnp.mean(self.s2, axis=-1) + eps))
        return jnp.concatenate(feats, axis=-1)


def _morlet_hat(n: int, xi: float, sigma: float) -> np.ndarray:
    """Frequency-sampled Morlet band-pass (analytic: support on [0, 0.5])."""
    freqs = np.fft.fftfreq(n)
    g = np.exp(-((freqs - xi) ** 2) / (2 * sigma**2))
    # admissibility: subtract the DC leak so psi_hat(0) = 0 exactly
    corr = np.exp(-(xi**2) / (2 * sigma**2))
    g = g - corr * np.exp(-(freqs**2) / (2 * sigma**2))
    g[freqs < 0] = 0.0
    return g


def _gauss_hat(n: int, sigma_t: float) -> np.ndarray:
    freqs = np.fft.fftfreq(n)
    return np.exp(-2 * (np.pi * sigma_t * freqs) ** 2)


def scattering_filterbank(
    n: int, J: int, Q: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(psi_hat [n_filters, n], xi [n_filters], phi_hat [n]) for length-n
    signals: geometric ladder of Morlets from ~0.45 down to the averaging
    band, Q per octave; Gaussian lowpass at scale 2^J."""
    xis = []
    xi = 0.425
    xi_min = max(1.0 / (1 << J), 2.0 / n)
    while xi > xi_min:
        xis.append(xi)
        xi *= 2.0 ** (-1.0 / Q)
    if not xis:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"No wavelets fit: J={J} leaves no band above {xi_min}",
            suggestions=("Reduce J or increase the signal length",),
        )
    # quality-factor bandwidth; wider for small Q so octaves stay covered
    denom = (2.0 ** (1.0 / Q) - 1.0) * 2.5
    psis = np.stack([_morlet_hat(n, x, max(x * denom, 1.0 / n)) for x in xis])
    phi = _gauss_hat(n, sigma_t=0.35 * (1 << J))
    return psis, np.asarray(xis), phi


def scattering1d(
    x: jnp.ndarray,
    *,
    J: int = 6,
    Q: int = 8,
    order: int = 2,
    Q2: int = 1,
    stride: int | None = None,
) -> ScatteringResult:
    """Scattering coefficients of ``[..., N]`` signals (periodic boundary).

    Args:
      J: averaging scale ``2^J`` samples — the invariance window.
      Q: first-order wavelets per octave (8 suits audio-like data).
      order: 1 or 2 (2 adds amplitude-modulation paths).
      Q2: second-order wavelets per octave (1 is standard).
      stride: output subsampling, default ``2^J`` (pass 1 for full rate).

    Returns :class:`ScatteringResult`; coefficients are non-negative.
    """
    n = x.shape[-1]
    if n < (1 << J):
        raise InvalidSignalError(
            ErrorCode.VAL_TOO_SHORT,
            f"Signal length {n} below the averaging scale 2^J={1 << J}",
        )
    if order not in (1, 2):
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG, f"order must be 1 or 2, got {order}"
        )
    if stride is None:
        stride = 1 << J
    if n % stride:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"stride {stride} must divide the signal length {n}",
        )
    real_dtype = (
        x.dtype if jnp.issubdtype(x.dtype, jnp.floating) else jnp.float32
    )
    cdtype = jnp.complex128 if real_dtype == jnp.float64 else jnp.complex64
    x = x.astype(real_dtype)

    psi1, xi1, phi = scattering_filterbank(n, J, Q)
    psi2, xi2, _ = scattering_filterbank(n, J, Q2)
    phi_d = jnp.asarray(phi[: n // 2 + 1], dtype=real_dtype)
    psi1_d = jnp.asarray(psi1, dtype=real_dtype).astype(cdtype)
    psi2_full = jnp.asarray(psi2, dtype=real_dtype).astype(cdtype)

    def lowpass(u):  # real input, real averaged output, subsampled
        spec = jnp.fft.rfft(u, axis=-1)
        out = jnp.fft.irfft(spec * phi_d, n=n, axis=-1)
        return out[..., ::stride]

    # order 0
    s0 = lowpass(x)

    # order 1: one batched complex product over the filter axis
    spec_x = jnp.fft.fft(x, axis=-1).astype(cdtype)
    u1 = jnp.abs(jnp.fft.ifft(spec_x[..., None, :] * psi1_d, axis=-1))
    s1 = lowpass(u1)

    if order == 1:
        return ScatteringResult(
            s0, s1, None, tuple(float(v) for v in xi1), (), ()
        )

    # order 2: only decreasing-frequency paths carry energy
    pairs = [
        (i1, i2)
        for i1 in range(len(xi1))
        for i2 in range(len(xi2))
        if xi2[i2] < 0.5 * xi1[i1]
    ]
    if pairs:
        bank2 = psi2_full[jnp.asarray([p[1] for p in pairs])]
        u1_sel = u1[..., jnp.asarray([p[0] for p in pairs]), :]
        spec_u1 = jnp.fft.fft(u1_sel, axis=-1).astype(cdtype)
        u2 = jnp.abs(jnp.fft.ifft(spec_u1 * bank2, axis=-1))
        s2 = lowpass(u2)
    else:
        s2 = jnp.zeros(x.shape[:-1] + (0, n // stride), dtype=real_dtype)
    return ScatteringResult(
        s0,
        s1,
        s2,
        tuple(float(v) for v in xi1),
        tuple(float(v) for v in xi2),
        tuple(pairs),
    )

"""Core à trous (MODWT) convolution ops in pure jnp.

Re-design of the reference scalar kernels
(``/root/reference/vectorwave-core/.../wavelet/internal/ScalarOps.java:640-916``).
The reference's hot loop is ``W_t = sum_l h_l * X_{(t - 2^(j-1) l) mod N}``
(Percival & Walden eq. 5.4, ``ScalarOps.java:700-723`` and the level-strided
variant ``:742-780``).  Here that loop becomes a sum of circularly-rolled
arrays — a static unroll over the (small) base filter with stride baked in, so
XLA can fuse the whole convolution into one vectorized pass over device
memory.

Boundary semantics (bit-parity with the reference):

* ``periodic``  — indices wrap mod N (``circularConvolveMODWTScalar``).
* ``zero``      — indices outside [0, N) contribute zero
  (``zeroPaddingConvolveMODWT`` :790-808).
* ``symmetric`` — half-point symmetric extension, period 2N
  (``symmetricConvolveMODWT`` :818-835 + ``MathUtils.symmetricBoundaryExtension``):
  implemented as a symmetric pad of the signal read through static slices.

All ops work over the last axis and broadcast over leading batch axes.
The generalized index is ``idx = t + sign*spacing*l + offset`` which covers
analysis (sign=-1), adjoint synthesis (sign=+1, ``MODWTTransform.java:244-256``)
and the symmetric-alignment offsets (``MultiLevelMODWTTransform.java:602-642``).
"""

from __future__ import annotations

from collections.abc import Sequence

import jax
import jax.numpy as jnp
import numpy as np

Boundary = str  # "periodic" | "zero" | "symmetric"

_VALID_BOUNDARIES = ("periodic", "zero", "symmetric")


def _normalize_boundary(boundary: str) -> str:
    b = boundary.lower()
    aliases = {
        "zero_padding": "zero",
        "zeropadding": "zero",
        "circular": "periodic",
        "wrap": "periodic",
        "sym": "symmetric",
        "reflect": "symmetric",
    }
    b = aliases.get(b, b)
    if b not in _VALID_BOUNDARIES:
        from ..errors import ErrorCode, InvalidArgumentError

        raise InvalidArgumentError(
            ErrorCode.CFG_UNSUPPORTED_BOUNDARY,
            f"Unknown boundary mode: {boundary!r}",
            suggestions=(f"Use one of {_VALID_BOUNDARIES}",),
        )
    return b


def effective_length(filter_length: int, level: int) -> int:
    """Length of the level-j à trous filter: (L0-1)*2^(j-1) + 1."""
    return (filter_length - 1) * (1 << (level - 1)) + 1


def _deltas(n_taps: int, spacing: int, sign: int, offset: int) -> list[int]:
    return [offset + sign * spacing * k for k in range(n_taps)]


def device_complex(arr, complex_dtype) -> jnp.ndarray:
    """Host complex constant -> device array, without any complex transfer.

    ``lax.complex`` assembles the value on device from two real transfers,
    so no runtime ever has to move a complex buffer between host and device
    (some cannot), and it folds to the same constant under jit.
    """
    arr = np.asarray(arr)
    real_dtype = np.float64 if complex_dtype == jnp.complex128 else np.float32
    re = jnp.asarray(np.real(arr).astype(real_dtype))
    im = jnp.asarray(np.imag(arr).astype(real_dtype))
    return jax.lax.complex(re, im).astype(complex_dtype)


def host_complex(arr: jnp.ndarray) -> np.ndarray:
    """Complex device array -> host ndarray, via two real transfers.

    The device->host direction of the same runtime limitation handled by
    :func:`device_complex`: pull ``.real``/``.imag`` (device-side projections)
    separately and recombine on the host.
    """
    if not jnp.iscomplexobj(arr):
        return np.asarray(arr)
    return np.asarray(arr.real) + 1j * np.asarray(arr.imag)


def fft_circular_convolve(
    x: jnp.ndarray,
    filt: np.ndarray,
    *,
    spacing: int = 1,
    sign: int = -1,
) -> jnp.ndarray:
    """FFT circular (de)convolution path for long effective filters (periodic).

    Counterpart of ``ScalarOps.circularConvolveMODWTFFT`` (:650-675), but using
    the XLA real FFT at the exact length N (no next-pow-2 complex padding — XLA
    handles arbitrary N via Bluestein's algorithm under the hood).
    ``sign=-1`` gives analysis convolution, ``sign=+1`` the adjoint correlation.
    """
    filt_np = np.asarray(filt, dtype=np.float64)
    n = x.shape[-1]
    length = (len(filt_np) - 1) * spacing + 1
    h_up = np.zeros(length)
    h_up[::spacing] = filt_np
    h_pad = np.zeros(n)
    # circular wrap of the upsampled filter into length N
    for start in range(0, length, n):
        chunk = h_up[start : start + n]
        h_pad[: len(chunk)] += chunk
    spec_h = np.fft.rfft(h_pad)
    if sign > 0:  # adjoint/correlation
        spec_h = np.conj(spec_h)
    spec_x = jnp.fft.rfft(x, axis=-1)
    out = jnp.fft.irfft(spec_x * device_complex(spec_h, spec_x.dtype), n=n, axis=-1)
    return out.astype(x.dtype)


def fft_analysis_pair(
    x: jnp.ndarray,
    low: np.ndarray,
    high: np.ndarray,
    *,
    spacing: int = 1,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """FFT periodic analysis for BOTH filters with one signal FFT
    (the fused counterpart of ``circularConvolveMODWTFFT``,
    ``ScalarOps.java:650-675``, for long base filters like dmey)."""
    n = x.shape[-1]
    spec_x = jnp.fft.rfft(x, axis=-1)

    def spec_of(filt):
        filt_np = np.asarray(filt, dtype=np.float64)
        length = (len(filt_np) - 1) * spacing + 1
        h_up = np.zeros(length)
        h_up[::spacing] = filt_np
        h_pad = np.zeros(n)
        for start in range(0, length, n):
            chunk = h_up[start : start + n]
            h_pad[: len(chunk)] += chunk
        return device_complex(np.fft.rfft(h_pad), spec_x.dtype)

    approx = jnp.fft.irfft(spec_x * spec_of(low), n=n, axis=-1)
    detail = jnp.fft.irfft(spec_x * spec_of(high), n=n, axis=-1)
    return approx.astype(x.dtype), detail.astype(x.dtype)


def _roll_sum(
    x: jnp.ndarray,
    taps: Sequence[tuple[int, float]],
    axis_len: int,
) -> jnp.ndarray:
    """sum_k c_k * roll(x, -delta_k) along the last axis."""
    out = None
    for delta, coeff in taps:
        shift = -delta % axis_len
        term = jnp.roll(x, -delta, axis=-1) if shift else x
        term = term * coeff
        out = term if out is None else out + term
    assert out is not None
    return out


def atrous_convolve(
    x: jnp.ndarray,
    filt: np.ndarray | jnp.ndarray,
    *,
    spacing: int = 1,
    boundary: str = "periodic",
    sign: int = -1,
    offset: int = 0,
) -> jnp.ndarray:
    """Generalized à trous convolution: ``out[t] = sum_l f[l] * x_ext[t + sign*spacing*l + offset]``.

    Args:
      x: ``[..., N]`` signal(s).
      filt: 1-D base filter (host constant; baked into the jaxpr).
      spacing: à trous stride ``2^(j-1)`` for level j.
      boundary: periodic / zero / symmetric extension.
      sign: -1 for analysis (causal, time-reversed filter), +1 for the adjoint
        synthesis indexing.
      offset: additional index offset (symmetric-alignment tau shifts).

    Returns:
      ``[..., N]`` filtered output, same dtype as ``x``.
    """
    boundary = _normalize_boundary(boundary)
    filt_np = np.asarray(filt)
    n = x.shape[-1]
    taps = list(zip(_deltas(len(filt_np), spacing, sign, offset), filt_np.tolist()))

    if boundary == "periodic":
        return _roll_sum(x, taps, n)

    # zero / symmetric: pad so every delta lands in-bounds, then static
    # slices.  Half-point symmetric extension is numpy's "symmetric" pad
    # mode, which reflects repeatedly when a pad is wider than the signal
    # (the 2N-periodic extension).  The padded form, not rolls of
    # [x, flip(x)], keeps XLA's GPU compile time short: a 128x64K 6-level
    # symmetric round trip built from those rolls did not compile within
    # ten minutes on an H100.
    deltas = [d for d, _ in taps]
    pad_left = max(0, -min(deltas))
    pad_right = max(0, max(deltas))
    pad_width = [(0, 0)] * (x.ndim - 1) + [(pad_left, pad_right)]
    mode = "symmetric" if boundary == "symmetric" else "constant"
    padded = jnp.pad(x, pad_width, mode=mode)
    out = None
    for delta, coeff in taps:
        start = pad_left + delta
        term = jax.lax.slice_in_dim(padded, start, start + n, axis=-1) * coeff
        out = term if out is None else out + term
    assert out is not None
    return out


def atrous_analysis_pair(
    x: jnp.ndarray,
    low: np.ndarray,
    high: np.ndarray,
    *,
    spacing: int = 1,
    boundary: str = "periodic",
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One-pass low+high analysis convolution (approx, detail).

    Mirrors the fused low/high single pass of the reference SIMD tier
    (``extensions/internal/VectorOps.java:887``): both outputs reuse the same
    rolled or padded views of ``x`` so XLA reads the signal once.
    """
    boundary = _normalize_boundary(boundary)
    low_np = np.asarray(low)
    high_np = np.asarray(high)
    n = x.shape[-1]
    n_taps = len(low_np)
    assert len(high_np) == n_taps

    pad_left = spacing * (n_taps - 1)
    if boundary != "periodic":
        # the padded form of atrous_convolve, shared by both filters
        pad_width = [(0, 0)] * (x.ndim - 1) + [(pad_left, 0)]
        mode = "symmetric" if boundary == "symmetric" else "constant"
        padded = jnp.pad(x, pad_width, mode=mode)
        approx = None
        detail = None
        for k in range(n_taps):
            start = pad_left - spacing * k
            view = jax.lax.slice_in_dim(padded, start, start + n, axis=-1)
            a = view * float(low_np[k])
            d = view * float(high_np[k])
            approx = a if approx is None else approx + a
            detail = d if detail is None else detail + d
        return approx, detail

    approx = None
    detail = None
    for k in range(n_taps):
        delta = -spacing * k
        rolled = jnp.roll(x, -delta, axis=-1) if delta % n else x
        a = rolled * float(low_np[k])
        d = rolled * float(high_np[k])
        approx = a if approx is None else approx + a
        detail = d if detail is None else detail + d
    return approx, detail

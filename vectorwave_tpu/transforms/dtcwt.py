"""Dual-tree complex wavelet transform (DTCWT), 1-D.

The practical middle ground the reference lacks between the decimated DWT
(critically sampled, badly shift-variant) and the MODWT/SWT (shift
invariant, (J+1)x redundant): two parallel decimated trees whose wavelets
form an approximate Hilbert pair give near-shift-invariant COMPLEX
coefficients (magnitude ~ local analytic envelope, phase ~ local position)
at only 2x redundancy — Kingsbury's q-shift construction.

Structure (all filters generated, none tabulated — see
``wavelets/qshift.py`` and ``tools/design_qshift.py``):

* level 1: both trees run the same orthonormal wavelet (default ``sym8``);
  tree b's analysis is offset one input sample (``offset=1`` in the
  decimated ops), i.e. a HALF-sample delay at the decimated rate.
* levels >= 2: tree a runs the q-shift pair (group delay ``(L-1)/2-1/4``),
  tree b the time-reversed pair (``+1/4``) — a further half-sample
  relative delay per stage, which is exactly the Hilbert-pair condition.
* complex coefficients ``z_j = (d_a - i d_b)/sqrt(2)`` (the sign that
  makes the pair analytic for this design; asserted by the spectrum test).

Each tree is orthonormal, so the inverse runs the exact adjoint cascade
per tree and averages — perfect reconstruction to machine precision, and
the averaging is what cancels the trees' opposite aliasing (the
shift-invariance mechanism).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from ..errors import ErrorCode, InvalidArgumentError
from ..ops.dwt import convolve_downsample, upsample_convolve
from ..wavelets.base import WaveletType
from ..wavelets.qshift import qshift_filters
from .modwt import _resolve_discrete, _validate_signal

__all__ = [
    "DTCWTResult",
    "dtcwt",
    "idtcwt",
    "dtcwt_max_levels",
    "coefficient_delay",
]


def coefficient_delay(level: int, wavelet="sym8") -> float:
    """Accumulated analysis group delay at ``level``, in units of that
    level's coefficient spacing (``2^level`` input samples).

    A feature at input position ``p`` lands at coefficient index
    ``(p - delay_samples) / 2^level`` (correlation-style analysis), so under
    periodic boundaries rolling a magnitude field by
    ``+round(coefficient_delay(j))`` aligns it with the signal (applies per
    axis for the 2-D transform).
    """
    h1, _ = _level1(wavelet)
    hq, _ = qshift_filters()
    delay = (len(h1) - 1) / 2.0  # level-1 stage, input samples
    for stage in range(2, level + 1):
        delay += (2 ** (stage - 1)) * (len(hq) - 1) / 2.0
    return delay / (1 << level)


class DTCWTResult(NamedTuple):
    """Complex highpasses (finest first, ``[..., N/2^j]``) + the two trees'
    final real lowpasses."""

    highpasses: tuple[jnp.ndarray, ...]
    lowpass_a: jnp.ndarray
    lowpass_b: jnp.ndarray

    @property
    def levels(self) -> int:
        return len(self.highpasses)

    def magnitudes(self) -> tuple[jnp.ndarray, ...]:
        """Shift-robust envelopes per level."""
        return tuple(jnp.abs(z) for z in self.highpasses)

    def level_energy(self) -> jnp.ndarray:
        """[..., J] energy per level (coefficient-domain)."""
        return jnp.stack(
            [jnp.sum(jnp.abs(z) ** 2, axis=-1) for z in self.highpasses],
            axis=-1,
        )


def _level1(wavelet):
    w = _resolve_discrete(wavelet)
    if w.wavelet_type is not WaveletType.ORTHOGONAL:
        raise InvalidArgumentError(
            ErrorCode.CFG_UNSUPPORTED_WAVELET,
            f"DTCWT level-1 wavelet must be orthogonal, got {w.name}",
            suggestions=("Use sym8 (default), a dbN, or coifN",),
        )
    return np.asarray(w.dec_lo), np.asarray(w.dec_hi)


def dtcwt_max_levels(n: int, wavelet="sym8") -> int:
    """Deepest usable level: every stage needs an even input length."""
    levels = 0
    while n % 2 == 0 and n // 2 >= len(_level1(wavelet)[0]):
        n //= 2
        levels += 1
    return levels


def dtcwt(
    x: jnp.ndarray,
    wavelet="sym8",
    *,
    levels: int,
) -> DTCWTResult:
    """Forward DTCWT of ``[..., N]`` signals (periodic boundaries).

    ``N`` must be divisible by ``2**levels``.  Returns complex highpasses
    per level plus both trees' final lowpasses.
    """
    h1, g1 = _level1(wavelet)
    hq, gq = qshift_filters()
    _validate_signal(x, min_length=2)
    n = x.shape[-1]
    if levels < 1:
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_LEVEL, f"levels must be >= 1, got {levels}"
        )
    if n % (1 << levels):
        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_SHAPE,
            f"N={n} must be divisible by 2^levels={1 << levels}",
            suggestions=("Pad the signal or reduce levels",),
        )
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    highpasses = []
    cur_a = cur_b = x
    for level in range(1, levels + 1):
        n_j = cur_a.shape[-1]
        ha, ga, hb, gb, off_b = (
            (h1, g1, h1, g1, 1) if level == 1
            else (hq, gq, hq[::-1], gq[::-1], 0)
        )
        d_a = convolve_downsample(cur_a, ga)
        a_a = convolve_downsample(cur_a, ha)
        d_b = convolve_downsample(cur_b, gb, offset=off_b)
        a_b = convolve_downsample(cur_b, hb, offset=off_b)
        highpasses.append((d_a - 1j * d_b) * inv_sqrt2)
        cur_a, cur_b = a_a, a_b
    return DTCWTResult(tuple(highpasses), cur_a, cur_b)


def idtcwt(result: DTCWTResult, wavelet="sym8") -> jnp.ndarray:
    """Inverse DTCWT: exact adjoint cascade per tree, averaged."""
    h1, g1 = _level1(wavelet)
    hq, gq = qshift_filters()
    sqrt2 = math.sqrt(2.0)
    cur_a, cur_b = result.lowpass_a, result.lowpass_b
    for level in range(result.levels, 0, -1):
        z = result.highpasses[level - 1]
        d_a = sqrt2 * jnp.real(z)
        d_b = -sqrt2 * jnp.imag(z)
        n_out = 2 * z.shape[-1]
        ha, ga, hb, gb, off_b = (
            (h1, g1, h1, g1, 1) if level == 1
            else (hq, gq, hq[::-1], gq[::-1], 0)
        )
        cur_a = upsample_convolve(cur_a, ha, n_out) + upsample_convolve(
            d_a, ga, n_out
        )
        cur_b = upsample_convolve(
            cur_b, hb, n_out, offset=off_b
        ) + upsample_convolve(d_b, gb, n_out, offset=off_b)
    return 0.5 * (cur_a + cur_b)

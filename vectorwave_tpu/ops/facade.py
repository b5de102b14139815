"""Operations facade: low-level MODWT convolution entry points + capability report.

Re-design of ``WaveletOperations``
(``/root/reference/vectorwave-core/.../wavelet/WaveletOperations.java:17-123``):
the scalar/FFT routing heuristic (``util/FftHeuristics.java:12-34``) is
replaced by a static rule — the strided roll formulation never materializes
à trous zeros, so the FFT path only engages for genuinely long base filters;
``get_performance_info`` reports the platform the way the reference reports
Vector API availability.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .convolve import atrous_convolve, fft_circular_convolve

#: FFT threshold on the BASE filter length.  The reference keys on the
#: upsampled length (FftHeuristics: N>=1024 && L > N/8) — a rule that is
#: unsatisfiable for base filters (L <= 62 implies N <= 496 < 1024), i.e. the
#: reference's MODWT FFT path can never trigger from its own heuristic.  Our
#: convolutions never touch the inserted zeros, so only the base tap count
#: matters; FFT engages only for custom registered filters longer than any
#: built-in family.  The crossover is not measured on the H100.
FFT_MIN_SIGNAL = 1024
FFT_MIN_TAPS = 64


def should_use_fft(signal_length: int, base_filter_length: int) -> bool:
    """FFT-vs-direct routing (role of FftHeuristics.shouldUseModwtFFT :30-34,
    re-derived for base filter lengths — see module constant)."""
    return base_filter_length >= FFT_MIN_TAPS and signal_length >= FFT_MIN_SIGNAL


def circular_convolve_modwt(
    x: jnp.ndarray, filt, *, spacing: int = 1
) -> jnp.ndarray:
    """Periodic MODWT convolution with automatic FFT routing
    (WaveletOperations.circularConvolveMODWT :29-39)."""
    filt = np.asarray(filt)
    if should_use_fft(x.shape[-1], len(filt)):
        return fft_circular_convolve(x, filt, spacing=spacing, sign=-1)
    return atrous_convolve(x, filt, spacing=spacing, boundary="periodic", sign=-1)


def zero_padding_convolve_modwt(
    x: jnp.ndarray, filt, *, spacing: int = 1
) -> jnp.ndarray:
    """Zero-extension MODWT convolution (ScalarOps.zeroPaddingConvolveMODWT)."""
    return atrous_convolve(x, filt, spacing=spacing, boundary="zero", sign=-1)


def symmetric_convolve_modwt(
    x: jnp.ndarray, filt, *, spacing: int = 1
) -> jnp.ndarray:
    """Symmetric-extension MODWT convolution (ScalarOps.symmetricConvolveMODWT)."""
    return atrous_convolve(x, filt, spacing=spacing, boundary="symmetric", sign=-1)


@dataclasses.dataclass(frozen=True)
class PerformanceInfo:
    """Platform capability report (WaveletOperations.getPerformanceInfo :68-90)."""

    platform: str
    device_kind: str
    device_count: int
    description: str


def get_performance_info() -> PerformanceInfo:
    devices = jax.devices()
    dev = devices[0]
    return PerformanceInfo(
        platform=dev.platform,
        device_kind=dev.device_kind,
        device_count=len(devices),
        description=(
            f"{len(devices)}x {dev.device_kind} ({dev.platform}); compute "
            "tier: XLA"
        ),
    )

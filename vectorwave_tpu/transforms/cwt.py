"""Continuous Wavelet Transform: FFT-accelerated, batched over scales.

Re-design of the reference CWT engine
(``/root/reference/vectorwave-core/.../wavelet/cwt/CWTTransform.java:22-884``,
``InverseCWT.java``, ``ScaleSpace.java``, the scale selectors, and the
extensions' ``ParallelCWTTransform``).

Design differences:

* The whole wavelet filter bank (all scales) is sampled host-side at trace
  time and convolved in ONE batched frequency-domain multiply —
  ``irfft(rfft(x) * conj(bank))`` — so scale parallelism is an array axis
  (replacing the reference's ``IntStream.parallel`` over scales,
  ``CWTTransform.java:249-253``) and XLA maps it onto the device.
* Linear convolution uses the reference's sizing ``nextpow2(N + support - 1)``
  (``CWTTransform.java:231-238``) with each scaled wavelet wrapped circularly
  around index 0, which makes the per-scale extraction offset vanish.
* The direct path is a ``lax.conv_general_dilated`` with the scales as output
  channels.
* ``icwt`` uses the log-scale single-sum reconstruction (Torrence & Compo
  eq. 11) with the admissibility constant calibrated numerically from the
  transform of a delta — the same role as ``InverseCWT``'s C_psi
  (``InverseCWT.java:46-554``) but robust for arbitrary wavelets.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..errors import ErrorCode, InvalidArgumentError, InvalidSignalError
from ..ops.convolve import device_complex as _device_complex
from ..wavelets.base import ContinuousWavelet
from ..wavelets.registry import as_wavelet

#: total support of the sampled wavelet in units of scale*bandwidth
#: (CWTTransform.WAVELET_SUPPORT_FACTOR = 8, i.e. +-4, CWTTransform.java:29)
SUPPORT_FACTOR = 8


class CWTResult(NamedTuple):
    """[..., S, N] coefficients plus the scale grid (cwt/CWTResult.java).

    ``boundary`` records how the forward transform treated edges: ``zero``
    (linear convolution, reference parity) or ``periodic`` (circular at N —
    gives exact equalized inversion).
    """

    coeffs: jnp.ndarray
    scales: tuple[float, ...]
    boundary: str = "zero"

    @property
    def n_scales(self) -> int:
        return len(self.scales)

    def magnitude(self) -> jnp.ndarray:
        return jnp.abs(self.coeffs)

    def phase(self) -> jnp.ndarray:
        """Phase angle (ComplexCWTResult.getPhase); zeros for real coeffs."""
        if jnp.iscomplexobj(self.coeffs):
            return jnp.angle(self.coeffs)
        return jnp.zeros_like(self.coeffs)

    def power(self) -> jnp.ndarray:
        return jnp.abs(self.coeffs) ** 2

    def scalogram(self) -> jnp.ndarray:
        """Per-scale energy over time [..., S]."""
        return (jnp.abs(self.coeffs) ** 2).sum(axis=-1)


def _resolve_continuous(wavelet) -> ContinuousWavelet:
    w = as_wavelet(wavelet)
    if not isinstance(w, ContinuousWavelet):
        raise InvalidArgumentError(
            ErrorCode.CFG_UNSUPPORTED_TRANSFORM,
            f"Wavelet {getattr(w, 'name', w)!r} is discrete; CWT requires a continuous wavelet",
            suggestions=("Use modwt()/swt() for discrete wavelets",),
        )
    return w


def validate_scales(scales) -> tuple:
    """Shared scale validation: non-empty, all positive; returns floats."""
    scales = tuple(float(s) for s in scales)
    if not scales:
        raise InvalidArgumentError(
            ErrorCode.VAL_TOO_SHORT, "At least one scale is required"
        )
    if any(s <= 0 for s in scales):
        raise InvalidArgumentError(
            ErrorCode.VAL_TOO_SHORT,
            "All scales must be positive",
            context={"scales": scales},
        )
    return scales


def _half_support(scale: float, bandwidth: float) -> int:
    return max(1, int(math.ceil(scale * bandwidth * SUPPORT_FACTOR / 2)))


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _sample_bank(
    w: ContinuousWavelet, scales: Sequence[float], fft_size: int
) -> tuple[np.ndarray, bool]:
    """Sample psi((k)/s)/sqrt(s) for each scale, wrapped circularly at 0."""
    bank = np.zeros((len(scales), fft_size), dtype=np.complex128)
    for row, scale in enumerate(scales):
        half = _half_support(scale, w.bandwidth)
        k = np.arange(-half, half + 1)
        vals = np.asarray(w.psi(k / scale)) / math.sqrt(scale)
        bank[row, k % fft_size] += vals
    is_complex = bool(np.iscomplexobj(np.asarray(w.psi(np.zeros(1)))))
    return bank, is_complex


#: above this FFT size the full frequency bank is assembled ON DEVICE from the
#: compact time-domain taps instead of baking an [S, fft_size] constant into
#: the program (a 64-scale 1M-sample CWT would otherwise embed ~0.5 GB)
_BAKED_BANK_MAX_FFT = 1 << 16


def _device_bank_spec(
    w: ContinuousWavelet,
    scales: tuple[float, ...],
    fft_size: int,
    real: bool,
    complex_dtype,
) -> jnp.ndarray:
    """conj(FFT(bank)) assembled on device from compact per-scale taps."""
    rows = []
    for scale in scales:
        half = _half_support(scale, w.bandwidth)
        k = np.arange(-half, half + 1)
        vals = np.asarray(w.psi(k / scale), dtype=np.complex128) / math.sqrt(scale)
        taps = _device_complex(vals, complex_dtype)
        row = jnp.zeros(fft_size, dtype=complex_dtype)
        row = row.at[: half + 1].add(taps[half:])
        row = row.at[fft_size - half :].add(taps[:half])
        rows.append(row)
    bank = jnp.stack(rows)
    if real:
        spec = jnp.fft.rfft(jnp.real(bank), axis=-1)
    else:
        spec = jnp.fft.fft(bank, axis=-1)
    return jnp.conj(spec)


class CWTConfig(NamedTuple):
    """CWT engine options (``cwt/CWTConfig.java:29-51`` role).

    The reference's knobs map as: ``boundaryMode`` -> ``boundary``;
    ``shouldUseFFT`` + the ``vectorwave.cwt.fft.threshold`` property ->
    ``method='auto'`` with ``fft_threshold``; ``fftSize`` (0 = auto) ->
    ``fft_size`` (validated against the linear-convolution minimum);
    ``normalizeAcrossScales`` is baked into the bank (1/sqrt(s) sampling);
    ``useStructuredConcurrency``/``memoryPool`` are JVM artifacts absorbed
    by XLA (scales batch on one device; buffers are XLA's).
    """

    boundary: str = "zero"
    method: str = "auto"  # auto | fft | direct
    fft_threshold: int = 64  # auto: FFT path when N >= threshold
    fft_size: int = 0  # 0 = auto (nextpow2(N + support - 1); N if periodic)
    analytic: bool = False

    def resolve_method(self, n: int) -> str:
        if self.method == "auto":
            return "fft" if n >= self.fft_threshold else "direct"
        return self.method


def cwt(
    x: jnp.ndarray,
    scales: Sequence[float],
    wavelet="morl",
    *,
    method: str = "fft",
    analytic: bool = False,
    boundary: str = "zero",
    config: CWTConfig | None = None,
) -> CWTResult:
    """Continuous wavelet transform (``CWTTransform.analyze`` :71-79).

    Args:
      x: ``[..., N]`` real signal(s).
      scales: static sequence of positive scales (baked at trace time).
      wavelet: continuous wavelet name or instance.
      method: ``fft`` (default) or ``direct`` (time-domain convolution;
        equivalent results, for short supports).
      analytic: for REAL wavelets, compute complex coefficients against the
        analytic (Hilbert) signal — ``analyzeComplex``'s real-wavelet path
        (``CWTTransform.java:88-103``).  Complex wavelets always produce
        complex coefficients.

    Returns:
      :class:`CWTResult` with coefficients ``[..., S, N]``.
    """
    w = _resolve_continuous(wavelet)
    scales = validate_scales(scales)
    n = x.shape[-1]
    if n < 1:
        raise InvalidSignalError(
            ErrorCode.VAL_TOO_SHORT,
            f"Signal length {n} below minimum 1",
            context={"shape": tuple(x.shape)},
        )
    if config is not None:
        boundary = config.boundary
        analytic = config.analytic
        method = config.resolve_method(n)
    if boundary == "periodic":
        fft_size = n
    else:
        max_support = max(2 * _half_support(s, w.bandwidth) + 1 for s in scales)
        fft_size = _next_pow2(n + max_support - 1)
    if config is not None and config.fft_size:
        if config.fft_size < fft_size:
            raise InvalidArgumentError(
                ErrorCode.CFG_INVALID_CONFIG,
                f"fft_size {config.fft_size} below the linear-convolution "
                f"minimum {fft_size}",
                suggestions=("Use fft_size=0 for automatic sizing",),
            )
        fft_size = config.fft_size
    if fft_size > _BAKED_BANK_MAX_FFT:
        bank = None
        is_complex = bool(np.iscomplexobj(np.asarray(w.psi(np.zeros(1)))))
    else:
        bank, is_complex = _sample_bank(w, scales, fft_size)
    complex_out = is_complex or analytic

    if method == "direct":
        return CWTResult(_cwt_direct(x, w, scales, complex_out), scales, boundary)
    if method != "fft":
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"Unknown CWT method: {method!r}",
            suggestions=("Use 'fft' or 'direct'",),
        )

    real_dtype = x.dtype if jnp.issubdtype(x.dtype, jnp.floating) else jnp.float32
    complex_dtype = jnp.complex128 if real_dtype == jnp.float64 else jnp.complex64

    big = fft_size > _BAKED_BANK_MAX_FFT
    if complex_out:
        spec_raw = jnp.fft.fft(x.astype(real_dtype), n=fft_size, axis=-1)
        mult = None
        if analytic and not is_complex:
            # analytic signal: double positive freqs, zero negative
            freq = np.fft.fftfreq(fft_size)
            mult = np.where(freq > 0, 2.0, np.where(freq == 0, 1.0, 0.0))

        spec_x = spec_raw
        if mult is not None:
            spec_x = spec_x * jnp.asarray(mult, dtype=real_dtype).astype(
                complex_dtype
            )
        if big:
            bank_spec = _device_bank_spec(w, scales, fft_size, False, complex_dtype)
        else:
            bank_h, _ = _sample_bank(w, scales, fft_size)
            bank_spec = _device_complex(
                np.conj(np.fft.fft(bank_h, axis=-1)), complex_dtype
            )
        prod = spec_x[..., None, :] * bank_spec
        return CWTResult(jnp.fft.ifft(prod, axis=-1)[..., :n], scales, boundary)

    out = _real_fft_rows(
        x, w, scales, fft_size, n, real_dtype, complex_dtype, big
    )
    return CWTResult(out.astype(real_dtype), scales, boundary)


def _real_fft_rows(
    x, w, scales_sub, fft_size: int, n: int, real_dtype, complex_dtype, big
):
    """FFT-path rows for real-wavelet scales: ``prod -> irfft`` synthesis
    (``CWTTransform.java:223-313``)."""
    spec_x = jnp.fft.rfft(x.astype(real_dtype), n=fft_size, axis=-1)
    if big:
        bank_spec = _device_bank_spec(w, scales_sub, fft_size, True, complex_dtype)
    else:
        bank_h, _ = _sample_bank(w, scales_sub, fft_size)
        bank_spec = _device_complex(
            np.conj(np.fft.rfft(bank_h.real, axis=-1)), complex_dtype
        )
    prod = spec_x[..., None, :] * bank_spec
    return jnp.fft.irfft(prod, n=fft_size, axis=-1)[..., :n].astype(real_dtype)


def _cwt_direct(
    x: jnp.ndarray, w: ContinuousWavelet, scales: tuple[float, ...], complex_out: bool
) -> jnp.ndarray:
    """Time-domain path: one grouped 1-D convolution, scales = output channels
    (replaces ``analyzeDirect`` :120-168)."""
    n = x.shape[-1]
    halves = [_half_support(s, w.bandwidth) for s in scales]
    max_half = max(halves)
    length = 2 * max_half + 1
    bank = np.zeros((len(scales), length), dtype=np.complex128)
    for row, (scale, half) in enumerate(zip(scales, halves)):
        k = np.arange(-half, half + 1)
        bank[row, max_half - half : max_half + half + 1] = (
            np.conj(np.asarray(w.psi(k / scale))) / math.sqrt(scale)
        )
    batch_shape = x.shape[:-1]
    lhs = x.reshape((-1, 1, n))

    def conv(filters: np.ndarray) -> jnp.ndarray:
        rhs = jnp.asarray(filters[:, None, :], dtype=x.dtype)  # [S, 1, L]
        out = jax.lax.conv_general_dilated(
            lhs.astype(x.dtype),
            rhs,
            window_strides=(1,),
            padding=[(max_half, max_half)],
            dimension_numbers=("NCH", "OIH", "NCH"),
        )
        return out.reshape(batch_shape + (len(scales), n))

    # correlation: out[s, i] = sum_k x[i+k'] psi*((k'-...)/s); flip for conv
    flipped = bank[:, ::-1]
    if complex_out:
        # lax.complex, not `re + 1j*im`: the scalar 1j is a complex constant
        # that some remote runtimes cannot transfer to the device in eager mode
        return jax.lax.complex(conv(flipped.real), conv(-flipped.imag))
    return conv(flipped.real)


# --------------------------------------------------------------------------
# Inverse CWT (InverseCWT.java:46-554)
# --------------------------------------------------------------------------


_CALIBRATION_CACHE: dict[tuple, float] = {}


def _delta_calibration(w: ContinuousWavelet, scales: tuple[float, ...]) -> float:
    """Reconstruction constant for the single-sum inverse — the numerical
    analogue of InverseCWT's admissibility constant C_psi.

    Calibrated host-side by least squares: transform a seeded noise signal
    band-limited to the frequency range the scale grid actually covers,
    reconstruct with C=1, and fit the scalar that recovers the input.  This
    is robust for every wavelet family (including odd/antisymmetric ones,
    where the classic delta formula degenerates because psi(0)=0).
    """
    key = (w.name, w.center_frequency, w.bandwidth, scales)
    cached = _CALIBRATION_CACHE.get(key)
    if cached is not None:
        return cached
    n = 1024
    rng = np.random.default_rng(12345)
    x = rng.standard_normal(n)
    # band-limit to the representable band of the scale grid
    f_hi = min(0.5, 1.5 * w.center_frequency / min(scales))
    f_lo = max(1.0 / n, w.center_frequency / max(scales) / 1.5)
    spec = np.fft.rfft(x)
    freqs = np.fft.rfftfreq(n)
    spec[(freqs < f_lo) | (freqs > f_hi)] = 0.0
    x = np.fft.irfft(spec, n)
    # numpy CWT with the same bank construction as the jnp path
    max_support = max(2 * _half_support(s, w.bandwidth) + 1 for s in scales)
    fft_size = _next_pow2(n + max_support - 1)
    bank, _ = _sample_bank(w, scales, fft_size)
    spec_x = np.fft.fft(x, fft_size)
    coeffs = np.fft.ifft(spec_x[None, :] * np.conj(np.fft.fft(bank, axis=-1)), axis=-1)[
        :, :n
    ]
    log_s = np.log(np.asarray(scales))
    dls = np.gradient(log_s) if len(scales) > 1 else np.ones(1)
    weights = dls / np.sqrt(np.asarray(scales))
    rec = np.real(coeffs).T @ weights
    denom = float(np.dot(rec, x))
    c = float(np.dot(rec, rec)) / denom if abs(denom) > 1e-12 else 1.0
    _CALIBRATION_CACHE[key] = c
    return c


def _aggregate_response(
    w: ContinuousWavelet, scales: tuple[float, ...], n: int, boundary: str = "zero"
) -> np.ndarray:
    """Net frequency response G(f) of the weighted single-sum reconstruction:
    ``sum_j w_j conj(psi_hat(s_j f))`` on the length-n rfft grid."""
    log_s = np.log(np.asarray(scales))
    dls = np.gradient(log_s) if len(scales) > 1 else np.ones(1)
    weights = dls / np.sqrt(np.asarray(scales))
    if boundary == "periodic":
        fft_size = n
    else:
        max_support = max(2 * _half_support(s, w.bandwidth) + 1 for s in scales)
        fft_size = _next_pow2(n + max_support - 1)
    bank, _ = _sample_bank(w, scales, fft_size)
    spec = np.conj(np.fft.fft(bank, axis=-1))  # conj(psi_hat) per scale
    agg = (weights[:, None] * spec).sum(axis=0)
    # resample the fft_size grid onto the length-n rfft bins; the observable
    # response of Re(acc) is the Hermitian part H(f) = (G(f) + conj(G(-f)))/2
    # (halves the response of analytic wavelets, keeps odd real wavelets'
    # purely imaginary response intact)
    freqs_n = np.fft.rfftfreq(n)
    freqs_m = np.fft.fftfreq(fft_size)
    order = np.argsort(freqs_m)
    fm, ar, ai = freqs_m[order], agg.real[order], agg.imag[order]

    def interp(f):
        return np.interp(f, fm, ar) + 1j * np.interp(f, fm, ai)

    return 0.5 * (interp(freqs_n) + np.conj(interp(-freqs_n)))


def icwt(
    result: CWTResult,
    wavelet="morl",
    *,
    equalize: bool = True,
) -> jnp.ndarray:
    """Inverse CWT (role of ``InverseCWT.reconstruct``).

    ``equalize=True`` (default) divides the log-scale single-sum
    reconstruction by the scale grid's aggregate frequency response, giving
    near-exact recovery inside the band the scales cover — substantially
    tighter than the reference's admissibility-constant reconstruction.
    ``equalize=False`` falls back to the classic single-sum formula
    (Torrence & Compo eq. 11) with a numerically calibrated constant.
    """
    w = _resolve_continuous(wavelet)
    scales = result.scales
    n = result.coeffs.shape[-1]
    log_s = np.log(np.asarray(scales))
    dls = np.gradient(log_s) if len(scales) > 1 else np.ones(1)
    weights = dls / np.sqrt(np.asarray(scales))
    real_coeffs = jnp.real(result.coeffs)
    acc = jnp.einsum(
        "...sn,s->...n", real_coeffs, jnp.asarray(weights, dtype=real_coeffs.dtype)
    )
    if not equalize:
        return acc / _delta_calibration(w, scales)
    g = _aggregate_response(w, scales, n, result.boundary)
    mag = np.abs(g)
    floor = 0.05 * mag.max()
    inv = np.where(mag > floor, 1.0 / np.where(mag > floor, g, 1.0), 0.0)
    spec = jnp.fft.rfft(acc, axis=-1)
    complex_dtype = jnp.complex128 if acc.dtype == jnp.float64 else jnp.complex64
    out = jnp.fft.irfft(
        spec * _device_complex(inv, complex_dtype), n=n, axis=-1
    )
    return out.astype(acc.dtype)


def reconstruct_band(
    result: CWTResult,
    wavelet,
    min_scale: float,
    max_scale: float,
) -> jnp.ndarray:
    """Band-limited reconstruction (``InverseCWT.reconstructBand``): only
    scales within [min_scale, max_scale] contribute (calibration keeps the
    FULL scale grid so bands sum to the full reconstruction)."""
    w = _resolve_continuous(wavelet)
    scales = result.scales
    log_s = np.log(np.asarray(scales))
    dls = np.gradient(log_s) if len(scales) > 1 else np.ones(1)
    mask = np.array([(min_scale <= s <= max_scale) for s in scales], dtype=np.float64)
    weights = mask * dls / np.sqrt(np.asarray(scales))
    c = _delta_calibration(w, scales)
    acc = jnp.einsum(
        "...sn,s->...n",
        jnp.real(result.coeffs),
        jnp.asarray(weights, dtype=jnp.real(result.coeffs).dtype),
    )
    return acc / c


def reconstruct_frequency_band(
    result: CWTResult,
    wavelet,
    min_freq: float,
    max_freq: float,
    *,
    dt: float = 1.0,
) -> jnp.ndarray:
    """Frequency-band reconstruction (``InverseCWT.reconstructFrequencyBand``)."""
    w = _resolve_continuous(wavelet)
    min_scale = frequency_to_scale(max_freq, w, dt=dt)
    max_scale = frequency_to_scale(min_freq, w, dt=dt)
    return reconstruct_band(result, w, min_scale, max_scale)


# --------------------------------------------------------------------------
# Scale spaces and selectors (ScaleSpace.java, *ScaleSelector.java)
# --------------------------------------------------------------------------


def scale_to_frequency(scale, wavelet, *, dt: float = 1.0):
    """f = fc / (s * dt) (ScaleSpace.java:241-266)."""
    w = _resolve_continuous(wavelet)
    return w.center_frequency / (np.asarray(scale) * dt)


def frequency_to_scale(freq, wavelet, *, dt: float = 1.0):
    w = _resolve_continuous(wavelet)
    return w.center_frequency / (np.asarray(freq) * dt)


def scales_linear(min_scale: float, max_scale: float, count: int) -> tuple[float, ...]:
    """Linear scale grid (ScaleSpace.linear :178)."""
    return tuple(np.linspace(min_scale, max_scale, count).tolist())


def scales_log(min_scale: float, max_scale: float, count: int) -> tuple[float, ...]:
    """Logarithmic scale grid (ScaleSpace.logarithmic :210)."""
    return tuple(np.geomspace(min_scale, max_scale, count).tolist())


def scales_dyadic(levels: int, *, voices_per_octave: int = 1) -> tuple[float, ...]:
    """Dyadic scales 2^(j/v) (ScaleSpace.dyadic :241; DyadicScaleSelector)."""
    j = np.arange(0, levels * voices_per_octave + 1)
    return tuple((2.0 ** (j / voices_per_octave)).tolist())


def select_scales_optimal(
    signal_length: int,
    wavelet,
    *,
    voices_per_octave: int = 10,
    dt: float = 1.0,
) -> tuple[float, ...]:
    """Nyquist-to-signal-length log coverage (OptimalScaleSelector.java):
    scales spanning fc/Nyquist .. fc/(4/N) with v voices per octave."""
    w = _resolve_continuous(wavelet)
    s_min = max(w.center_frequency / (0.5 / dt), 2 * dt * w.center_frequency)
    s_max = w.center_frequency * signal_length * dt / 4.0
    octaves = max(1, int(math.ceil(math.log2(s_max / s_min))))
    j = np.arange(octaves * voices_per_octave + 1)
    return tuple((s_min * 2.0 ** (j / voices_per_octave)).tolist())


def select_scales_signal_adaptive(
    x: np.ndarray,
    wavelet,
    *,
    n_scales: int = 32,
    dt: float = 1.0,
) -> tuple[float, ...]:
    """Energy-adaptive scale selection (SignalAdaptiveScaleSelector.java):
    allocate scales where the signal spectrum carries energy.  Host-side
    (data-dependent scale choice happens before tracing)."""
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    n = len(x)
    spec = np.abs(np.fft.rfft(x - x.mean())) ** 2
    freqs = np.fft.rfftfreq(n, d=dt)
    spec[0] = 0.0
    if spec.sum() <= 0:
        return select_scales_optimal(n, wavelet, voices_per_octave=max(4, n_scales // 8), dt=dt)
    cdf = np.cumsum(spec) / spec.sum()
    # sample frequencies at equal energy quantiles (clipped away from DC)
    quantiles = np.linspace(0.02, 0.98, n_scales)
    freq_samples = np.interp(quantiles, cdf, freqs)
    freq_samples = np.clip(freq_samples, freqs[1], freqs[-1])
    w = _resolve_continuous(wavelet)
    scales = np.unique(w.center_frequency / (freq_samples * dt))
    return tuple(scales.tolist())  # np.unique is ascending, like the other selectors


class ScaleSelectionConfig(NamedTuple):
    """Adaptive scale-selection options
    (``AdaptiveScaleSelector.ScaleSelectionConfig`` builder,
    ``cwt/AdaptiveScaleSelector.java:80-271``).

    ``min_frequency``/``max_frequency`` of 0 mean auto-detect.
    ``spacing`` is one of ``linear`` / ``logarithmic`` / ``dyadic``.
    """

    sampling_rate: float
    min_frequency: float = 0.0
    max_frequency: float = 0.0
    scales_per_octave: int = 10
    use_signal_adaptation: bool = True
    max_scales: int = 200
    spacing: str = "logarithmic"


def estimate_scale_count(
    min_freq: float, max_freq: float, *, scales_per_octave: int = 10
) -> int:
    """Scales needed for a frequency range
    (``AdaptiveScaleSelector.estimateScaleCount`` :57-76)."""
    if min_freq <= 0 or max_freq <= min_freq:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"Invalid frequency range [{min_freq}, {max_freq}]",
        )
    octaves = math.log2(max_freq / min_freq)
    return max(1, int(math.ceil(octaves * scales_per_octave)))


def frequency_range_of_scales(
    scales, wavelet, sampling_rate: float
) -> tuple[float, float]:
    """[minFreq, maxFreq] analyzed by ascending ``scales``
    (``AdaptiveScaleSelector.getFrequencyRange`` :37-55)."""
    scales = np.asarray(scales, dtype=np.float64)
    if scales.size == 0:
        return (0.0, 0.0)
    w = _resolve_continuous(wavelet)
    fc = w.center_frequency
    return (fc * sampling_rate / scales[-1], fc * sampling_rate / scales[0])


def select_scales_adaptive(
    x: np.ndarray,
    wavelet,
    config: ScaleSelectionConfig,
) -> tuple[float, ...]:
    """Config-driven adaptive scale selection
    (``AdaptiveScaleSelector.selectScales`` :17-35).

    Auto-detects the frequency range from the signal spectrum (energy
    quantiles, like :func:`select_scales_signal_adaptive`) when
    ``use_signal_adaptation`` is on, otherwise spans a-few-cycles .. Nyquist;
    then lays out up to ``max_scales`` scales in the requested spacing.
    Host-side: scale choice is data-dependent and happens before tracing.
    """
    w = _resolve_continuous(wavelet)
    fs = float(config.sampling_rate)
    if fs <= 0:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG, f"sampling_rate must be > 0, got {fs}"
        )
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    n = len(x)
    nyquist = fs / 2.0
    f_lo = config.min_frequency if config.min_frequency > 0 else 4.0 * fs / max(n, 8)
    f_hi = config.max_frequency if config.max_frequency > 0 else 0.5 * nyquist
    if config.use_signal_adaptation and n >= 16:
        spec = np.abs(np.fft.rfft(x - x.mean())) ** 2
        freqs = np.fft.rfftfreq(n, d=1.0 / fs)
        spec[0] = 0.0
        total = spec.sum()
        if total > 0:
            cdf = np.cumsum(spec) / total
            lo = float(np.interp(0.01, cdf, freqs))
            hi = float(np.interp(0.99, cdf, freqs))
            if config.min_frequency <= 0:
                f_lo = max(f_lo / 4.0, min(f_lo, lo))
            if config.max_frequency <= 0:
                f_hi = min(nyquist, max(f_hi, hi))
    f_lo = max(f_lo, fs / n)
    f_hi = max(min(f_hi, nyquist), f_lo * 1.0001)
    count = min(
        config.max_scales,
        estimate_scale_count(f_lo, f_hi, scales_per_octave=config.scales_per_octave),
    )
    fc = w.center_frequency
    s_min = fc * fs / f_hi  # high frequency -> small scale
    s_max = fc * fs / f_lo
    spacing = config.spacing.lower()
    if spacing.startswith("lin"):
        scales = np.linspace(s_min, s_max, count)
    elif spacing.startswith("dya"):
        j_lo = math.floor(math.log2(s_min))
        j_hi = math.ceil(math.log2(s_max))
        scales = 2.0 ** np.arange(j_lo, j_hi + 1)
        scales = scales[(scales >= s_min / 2) & (scales <= s_max * 2)][
            : config.max_scales
        ]
    elif spacing.startswith("log"):
        scales = np.geomspace(s_min, s_max, count)
    else:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"Unknown scale spacing {config.spacing!r}",
            suggestions=("Use 'linear', 'logarithmic' or 'dyadic'",),
        )
    return tuple(np.asarray(scales, dtype=np.float64).tolist())

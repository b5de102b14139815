"""Continuous (CWT) wavelet library.

Counterpart of the reference's CWT wavelet classes
(``/root/reference/vectorwave-core/.../wavelet/cwt/*.java`` and
``cwt/finance/*.java``: Morlet, ComplexMorlet, MexicanHat/Ricker,
MATLABMexicanHat, GaussianDerivative, ComplexGaussian, Shannon,
ClassicalShannon, ComplexShannon, ShannonGabor, FrequencyBSpline,
ContinuousMeyer, Morse, Hermitian, Paul, DOG).

Each wavelet is a :class:`ContinuousWavelet` whose ``psi`` evaluates the
mother function on a numpy time grid (host-side — the CWT samples filters at
trace time and bakes them into the jit graph).  Frequency-domain-defined
families (continuous Meyer, Morse) are materialized once on a dense grid by
inverse FFT and evaluated by interpolation.

Conventions: ``center_frequency`` is in cycles/sample at scale 1
(scale-to-frequency conversion f = fc / (s dt), ScaleSpace.java:241-266);
``bandwidth`` drives the CWT support sizing (support ~ 8 * s * bandwidth,
CWTTransform.java:29).  All wavelets are L2-normalized numerically.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from .base import ContinuousWavelet

_PI4 = math.pi ** (-0.25)


def _l2_normalized(psi, is_complex: bool, grid_half: float = 64.0, n: int = 1 << 16):
    """Wrap psi so it is unit-energy on a dense grid (matches the reference's
    per-wavelet normalization constants, cwt/WAVELET_NORMALIZATION.md)."""
    t = np.linspace(-grid_half, grid_half, n)
    vals = psi(t)
    energy = np.trapezoid(np.abs(vals) ** 2, t)
    scale = 1.0 / math.sqrt(float(energy))

    def normalized(tt: np.ndarray) -> np.ndarray:
        return psi(np.asarray(tt, dtype=np.float64)) * scale

    return normalized


def _freq_domain_wavelet(spectrum_fn, grid_half: float = 256.0, n: int = 1 << 18):
    """Materialize a frequency-defined wavelet on a time grid; returns an
    interpolating psi."""
    dt = 2 * grid_half / n
    omega = 2 * np.pi * np.fft.fftfreq(n, d=dt)
    spec = spectrum_fn(omega)
    vals = np.fft.ifft(spec) / dt
    vals = np.fft.fftshift(vals)
    t_grid = np.arange(-n // 2, n // 2) * dt
    energy = np.trapezoid(np.abs(vals) ** 2, t_grid)
    vals = vals / math.sqrt(float(energy))

    def psi(t: np.ndarray) -> np.ndarray:
        t = np.asarray(t, dtype=np.float64)
        real = np.interp(t, t_grid, vals.real, left=0.0, right=0.0)
        imag = np.interp(t, t_grid, vals.imag, left=0.0, right=0.0)
        return real + 1j * imag

    return psi


# --------------------------------------------------------------------------
# Morlet family (cwt/MorletWavelet.java, ComplexMorletWavelet.java)
# --------------------------------------------------------------------------


def morlet(omega0: float = 6.0, sigma: float = 1.0) -> ContinuousWavelet:
    """Real Morlet with admissibility correction
    (MorletWavelet.java:46-92: carrier cos(omega0 t), gaussian envelope,
    correction term exp(-omega0^2 sigma^2 / 2))."""
    correction = math.exp(-0.5 * omega0 * omega0 * sigma * sigma)

    def raw(t):
        return (np.cos(omega0 * t) - correction) * np.exp(-0.5 * (t / sigma) ** 2)

    return ContinuousWavelet(
        name="morl",
        family="Morlet",
        psi=_l2_normalized(raw, False),
        center_frequency=omega0 / (2 * math.pi),
        bandwidth=sigma,
        is_complex=False,
        description=f"Morlet wavelet (omega0={omega0}, sigma={sigma})",
    )


def complex_morlet(omega0: float = 6.0, sigma: float = 1.0) -> ContinuousWavelet:
    """Analytic Morlet: pi^-1/4 e^{i omega0 t} e^{-t^2/2sigma^2}."""

    def raw(t):
        return np.exp(1j * omega0 * t) * np.exp(-0.5 * (t / sigma) ** 2)

    return ContinuousWavelet(
        name="cmor",
        family="ComplexMorlet",
        psi=_l2_normalized(raw, True),
        center_frequency=omega0 / (2 * math.pi),
        bandwidth=sigma,
        is_complex=True,
        description=f"Complex Morlet wavelet (omega0={omega0}, sigma={sigma})",
    )


# --------------------------------------------------------------------------
# Gaussian-derivative family (RickerWavelet, MATLABMexicanHat,
# GaussianDerivativeWavelet, ComplexGaussianWavelet, DOGWavelet,
# HermitianWavelet)
# --------------------------------------------------------------------------


def _hermite_phys(n: int, t: np.ndarray) -> np.ndarray:
    """Physicists' Hermite polynomial H_n(t) by recurrence."""
    h_prev = np.ones_like(t)
    if n == 0:
        return h_prev
    h = 2 * t
    for k in range(1, n):
        h, h_prev = 2 * t * h - 2 * k * h_prev, h
    return h


def gaussian_derivative(order: int = 1) -> ContinuousWavelet:
    """n-th derivative of a Gaussian (GaussianDerivativeWavelet.java):
    d^n/dt^n e^{-t^2/2} = (-1)^n H_n(t/sqrt2)... expressed via Hermite."""

    def raw(t):
        return _hermite_phys(order, t / math.sqrt(2.0)) * np.exp(-0.5 * t * t)

    return ContinuousWavelet(
        name=f"gaus{order}",
        family="GaussianDerivative",
        psi=_l2_normalized(raw, False),
        center_frequency=math.sqrt(order) / (2 * math.pi) if order else 0.1,
        bandwidth=1.0,
        is_complex=False,
        description=f"Gaussian derivative wavelet of order {order}",
    )


def dog(order: int = 2) -> ContinuousWavelet:
    """Derivative-of-Gaussian (Torrence & Compo; finance/DOGWavelet.java)."""
    base = gaussian_derivative(order)
    return ContinuousWavelet(
        name=f"dog{order}",
        family="DOG",
        psi=base.psi,
        center_frequency=base.center_frequency,
        bandwidth=base.bandwidth,
        is_complex=False,
        description=f"DOG wavelet of order {order}",
    )


def mexican_hat() -> ContinuousWavelet:
    """Mexican hat / Ricker = 2nd Gaussian derivative (RickerWavelet.java):
    (2/(sqrt3 pi^1/4)) (1-t^2) e^{-t^2/2}."""

    def raw(t):
        return (1.0 - t * t) * np.exp(-0.5 * t * t)

    return ContinuousWavelet(
        name="mexh",
        family="MexicanHat",
        psi=_l2_normalized(raw, False),
        center_frequency=math.sqrt(2.0) / (2 * math.pi),
        bandwidth=1.0,
        is_complex=False,
        description="Mexican hat (Ricker) wavelet",
    )


def matlab_mexican_hat() -> ContinuousWavelet:
    """MATLAB-parity mexh (finance/MATLABMexicanHat.java): identical shape,
    MATLAB's explicit normalization constant 2/(sqrt(3) pi^(1/4))."""
    base = mexican_hat()
    return ContinuousWavelet(
        name="mexh_matlab",
        family="MexicanHat",
        psi=base.psi,
        center_frequency=base.center_frequency,
        bandwidth=base.bandwidth,
        is_complex=False,
        description="MATLAB-compatible Mexican hat wavelet",
    )


def complex_gaussian(order: int = 1) -> ContinuousWavelet:
    """cgauN (ComplexGaussianWavelet.java): n-th derivative of e^{-it} e^{-t^2}."""

    def raw(t):
        # derivative computed via finite-difference-free analytic form:
        # d^n/dt^n [e^{-it} e^{-t^2}] expressed with complex Hermite argument
        z = t + 0.5j
        return (-1) ** order * _hermite_complex(order, z) * np.exp(-1j * t) * np.exp(
            -t * t
        )

    # Spectral peak of |psi_hat|: with psi = d^n/dt^n [e^{-it} e^{-t^2}],
    # |psi_hat(w)| ~ w^n e^{-(w-1)^2/4}, maximized at w* = (1+sqrt(1+8n))/2.
    # (The reference's sqrt(n+1/2)/(sigma*sqrt(2pi)) formula,
    # ComplexGaussianWavelet.java:169, describes its UNmodulated variant.)
    w_peak = (1.0 + math.sqrt(1.0 + 8.0 * order)) / 2.0
    return ContinuousWavelet(
        name=f"cgau{order}",
        family="ComplexGaussian",
        psi=_l2_normalized(raw, True),
        center_frequency=w_peak / (2 * math.pi),
        bandwidth=1.0,
        is_complex=True,
        description=f"Complex Gaussian wavelet of order {order}",
    )


def _hermite_complex(n: int, z: np.ndarray) -> np.ndarray:
    """Hermite-like polynomial for the cgau closed form: with
    f = e^{-it-t^2} = e^{1/4} e^{-(t+i/2)^2}, d^n/dt^n f = (-1)^n He_n-style
    polynomial in (t + i/2) times f — use the physicists' recurrence scaled
    for argument sqrt2*(t+i/2)... computed by direct recurrence on
    g_n = d^n/dz^2-type terms.
    """
    # derivative of e^{-(z)^2} w.r.t. t where z = t + i/2:
    # d^n/dt^n e^{-z^2} = (-1)^n H_n(z) e^{-z^2} with physicists' H_n
    h_prev = np.ones_like(z)
    if n == 0:
        return h_prev
    h = 2 * z
    for k in range(1, n):
        h, h_prev = 2 * z * h - 2 * k * h_prev, h
    return h


def hermitian(order: int = 2) -> ContinuousWavelet:
    """Hermitian wavelet (HermitianWavelet.java): analytic counterpart of the
    n-th Gaussian derivative (negative frequencies suppressed)."""
    base = gaussian_derivative(order)

    def spectrum(omega):
        # FT of the real gaussian-derivative, doubled on positive freqs
        spec = (1j * omega) ** order * np.exp(-0.5 * omega * omega)
        return np.where(omega > 0, 2.0 * spec, np.where(omega == 0, spec, 0.0))

    psi = _freq_domain_wavelet(spectrum, grid_half=64.0, n=1 << 16)
    return ContinuousWavelet(
        name=f"herm{order}",
        family="Hermitian",
        psi=psi,
        center_frequency=base.center_frequency,
        bandwidth=1.0,
        is_complex=True,
        description=f"Hermitian (analytic Gaussian-derivative) wavelet, order {order}",
    )


# --------------------------------------------------------------------------
# Shannon family (ShannonWavelet, ClassicalShannonWavelet,
# ComplexShannonWavelet, ShannonGaborWavelet, FrequencyBSplineWavelet)
# --------------------------------------------------------------------------


def _sinc(x: np.ndarray) -> np.ndarray:
    return np.sinc(x)  # normalized sinc sin(pi x)/(pi x)


def shannon() -> ContinuousWavelet:
    """Real Shannon wavelet, band [1/2, 1] cycles/sample:
    psi(t) = 2 sinc(2t) - sinc(t) (ClassicalShannonWavelet form)."""

    def raw(t):
        return 2.0 * _sinc(2.0 * t) - _sinc(t)

    return ContinuousWavelet(
        name="shan",
        family="Shannon",
        psi=_l2_normalized(raw, False, grid_half=512.0, n=1 << 18),
        center_frequency=0.75,
        bandwidth=0.5,
        is_complex=False,
        description="Shannon wavelet (ideal band-pass)",
    )


def classical_shannon() -> ContinuousWavelet:
    """finance/ClassicalShannonWavelet.java — same ideal band-pass form."""
    base = shannon()
    return ContinuousWavelet(
        name="cshan",
        family="Shannon",
        psi=base.psi,
        center_frequency=base.center_frequency,
        bandwidth=base.bandwidth,
        is_complex=False,
        description="Classical Shannon wavelet",
    )


def complex_shannon(bandwidth: float = 1.0, center: float = 1.0) -> ContinuousWavelet:
    """shan B-C (ComplexShannonWavelet.java): sqrtB sinc(Bt) e^{2 pi i C t}."""

    def raw(t):
        return _sinc(bandwidth * t) * np.exp(2j * math.pi * center * t)

    return ContinuousWavelet(
        name="cshanb",
        family="ComplexShannon",
        psi=_l2_normalized(raw, True, grid_half=512.0, n=1 << 18),
        center_frequency=center,
        bandwidth=max(bandwidth, 0.5),
        is_complex=True,
        description=f"Complex Shannon wavelet (B={bandwidth}, C={center})",
    )


def shannon_gabor(bandwidth: float = 1.0, center: float = 0.75) -> ContinuousWavelet:
    """finance/ShannonGaborWavelet.java: Gaussian-windowed Shannon — the
    window tames the sinc ringing for financial series."""

    def raw(t):
        return (
            _sinc(bandwidth * t)
            * np.cos(2 * math.pi * center * t)
            * np.exp(-0.5 * (bandwidth * t / 4.0) ** 2)
        )

    return ContinuousWavelet(
        name="shangabor",
        family="ShannonGabor",
        psi=_l2_normalized(raw, False, grid_half=256.0, n=1 << 17),
        center_frequency=center,
        bandwidth=max(bandwidth, 0.5),
        is_complex=False,
        description=f"Shannon-Gabor wavelet (B={bandwidth}, C={center})",
    )


def frequency_bspline(order: int = 2, bandwidth: float = 1.0, center: float = 1.0) -> ContinuousWavelet:
    """fbsp m-B-C (FrequencyBSplineWavelet.java):
    sqrtB sinc^m(B t / m) e^{2 pi i C t}."""

    def raw(t):
        return _sinc(bandwidth * t / order) ** order * np.exp(2j * math.pi * center * t)

    return ContinuousWavelet(
        name="fbsp",
        family="FrequencyBSpline",
        psi=_l2_normalized(raw, True, grid_half=512.0, n=1 << 18),
        center_frequency=center,
        bandwidth=max(bandwidth, 0.5),
        is_complex=True,
        description=f"Frequency B-spline wavelet (m={order}, B={bandwidth}, C={center})",
    )


# --------------------------------------------------------------------------
# Paul (finance/PaulWavelet.java), Meyer, Morse
# --------------------------------------------------------------------------


def paul(order: int = 4) -> ContinuousWavelet:
    """Paul wavelet (PaulWavelet.java; Torrence & Compo Table 1):
    psi(t) = (2^m i^m m!) / sqrt(pi (2m)!) * (1 - it)^-(m+1).
    Strongly asymmetric in time — the reference uses it for crash detection.
    """
    m = order
    norm = (2.0**m * math.factorial(m)) / math.sqrt(math.pi * math.factorial(2 * m))

    def raw(t):
        return norm * (1j**m) * (1.0 - 1j * t) ** (-(m + 1))

    return ContinuousWavelet(
        name=f"paul{order}",
        family="Paul",
        psi=_l2_normalized(raw, True),
        center_frequency=(2 * m + 1) / (4 * math.pi),
        bandwidth=1.0,
        is_complex=True,
        description=f"Paul wavelet of order {order}",
    )


def continuous_meyer() -> ContinuousWavelet:
    """Continuous Meyer wavelet (ContinuousMeyerWavelet.java) via its exact
    spectrum (C^3 taper), materialized by inverse FFT."""
    from .fourier_families import _meyer_nu

    def spectrum(omega):
        aw = np.abs(omega)
        out = np.zeros_like(aw, dtype=np.complex128)
        band1 = (aw >= 2 * np.pi / 3) & (aw <= 4 * np.pi / 3)
        band2 = (aw > 4 * np.pi / 3) & (aw <= 8 * np.pi / 3)
        out[band1] = np.sin(np.pi / 2 * _meyer_nu(3 * aw[band1] / (2 * np.pi) - 1))
        out[band2] = np.cos(np.pi / 2 * _meyer_nu(3 * aw[band2] / (4 * np.pi) - 1))
        return out * np.exp(-0.5j * omega)

    return ContinuousWavelet(
        name="meyr",
        family="Meyer",
        psi=_freq_domain_wavelet(spectrum, grid_half=128.0, n=1 << 17),
        center_frequency=0.7,
        bandwidth=1.0,
        is_complex=False,
        description="Continuous Meyer wavelet",
    )


def morse(beta: float = 3.0, gamma: float = 3.0) -> ContinuousWavelet:
    """Generalized Morse wavelet (MorseWavelet.java): analytic,
    Psi(omega) = U(omega) a omega^beta e^{-omega^gamma}; peak frequency
    (beta/gamma)^(1/gamma)."""

    def spectrum(omega):
        pos = omega > 0
        out = np.zeros_like(omega, dtype=np.complex128)
        w = omega[pos]
        out[pos] = 2.0 * np.power(w, beta) * np.exp(-np.power(w, gamma))
        return out

    peak = (beta / gamma) ** (1.0 / gamma)
    return ContinuousWavelet(
        name=f"morse{int(beta)}_{int(gamma)}",
        family="Morse",
        psi=_freq_domain_wavelet(spectrum, grid_half=128.0, n=1 << 17),
        center_frequency=peak / (2 * math.pi),
        bandwidth=1.0,
        is_complex=True,
        description=f"Generalized Morse wavelet (beta={beta}, gamma={gamma})",
    )


@functools.lru_cache(maxsize=None)
def _cached(name: str) -> ContinuousWavelet:
    return _BUILDERS[name]()


_BUILDERS = {
    "morl": morlet,
    "cmor": complex_morlet,
    "mexh": mexican_hat,
    "ricker": mexican_hat,
    "mexh_matlab": matlab_mexican_hat,
    "shan": shannon,
    "cshan": classical_shannon,
    "cshanb": complex_shannon,
    "shangabor": shannon_gabor,
    "fbsp": frequency_bspline,
    "meyr": continuous_meyer,
    "morse": morse,
    **{f"gaus{n}": functools.partial(gaussian_derivative, n) for n in range(1, 9)},
    **{f"cgau{n}": functools.partial(complex_gaussian, n) for n in range(1, 9)},
    **{f"dog{n}": functools.partial(dog, n) for n in (1, 2, 3, 4, 6)},
    **{f"paul{n}": functools.partial(paul, n) for n in (1, 2, 3, 4, 5, 6)},
    **{f"herm{n}": functools.partial(hermitian, n) for n in (1, 2, 3, 4)},
}


def register_continuous(register, alias) -> None:
    """Hook for the registry: registers every continuous wavelet factory."""
    for name, builder in _BUILDERS.items():
        register(name, builder)
    alias("mexican_hat", "mexh")
    alias("morlet", "morl")
    alias("paul", "paul4")
    alias("dog", "dog2")
    alias("gaussian", "gaus1")

"""Wavelet type system.

Re-design of the reference's sealed ``Wavelet`` hierarchy
(``/root/reference/vectorwave-core/.../wavelet/api/Wavelet.java:41-183``,
``OrthogonalWavelet.java``, ``BiorthogonalWavelet.java``,
``ContinuousWavelet.java``): instead of an interface tree, wavelets are frozen
dataclasses holding plain float64 numpy coefficient arrays.  Filters are host
constants — they get baked into jitted computations at trace time, which is the
idiomatic JAX treatment of small static parameters.

Conventions (identical to the reference so coefficient parity holds):

* ``dec_lo`` (h): low-pass decomposition filter, causal ordering — the MODWT
  analysis convolution is ``W_t = sum_l h_l * X_{(t-l) mod N}``.
* QMF: ``dec_hi[i] = (-1)^i * dec_lo[L-1-i]``
  (``Wavelet.java:143-147``, ``Daubechies.java:322-330``).
* Orthogonal wavelets: reconstruction filters equal decomposition filters; the
  synthesis convolution uses adjoint ``(t+l)`` indexing
  (``OrthogonalWavelet.java:23-35``, ``MODWTTransform.java:244-256``).
* Biorthogonal: ``dec_hi = qmf_alt(rec_lo)``, ``rec_hi = qmf_alt(dec_lo)``
  (``Wavelet.java:165-180``).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Callable

import numpy as np


class WaveletType(enum.Enum):
    ORTHOGONAL = "orthogonal"
    BIORTHOGONAL = "biorthogonal"
    CONTINUOUS = "continuous"
    COMPLEX_CONTINUOUS = "complex_continuous"


class TransformType(enum.Enum):
    """Transform-compatibility categories (reference: api/TransformType.java)."""

    MODWT = "modwt"
    SWT = "swt"
    CWT = "cwt"


def qmf_highpass(low: np.ndarray) -> np.ndarray:
    """Quadrature-mirror high-pass: ``g[i] = (-1)^i * h[L-1-i]``."""
    low = np.asarray(low, dtype=np.float64)
    length = low.shape[0]
    signs = np.where(np.arange(length) % 2 == 0, 1.0, -1.0)
    return signs * low[::-1]


def qmf_alternate(low: np.ndarray) -> np.ndarray:
    """Biorthogonal high-pass builder: ``g[i] = (-1)^(L-1-i) * h[L-1-i]``.

    This is ``reverseWithAlternatingSigns`` from the reference
    (``Wavelet.java:165-180``): the sign pattern follows the *source* index.
    """
    low = np.asarray(low, dtype=np.float64)
    length = low.shape[0]
    src = np.arange(length - 1, -1, -1)
    signs = np.where(src % 2 == 0, 1.0, -1.0)
    return signs * low[::-1]


@dataclasses.dataclass(frozen=True)
class DiscreteWavelet:
    """A discrete wavelet: four filters plus metadata."""

    name: str
    family: str
    dec_lo: np.ndarray
    dec_hi: np.ndarray
    rec_lo: np.ndarray
    rec_hi: np.ndarray
    vanishing_moments: int = 0
    wavelet_type: WaveletType = WaveletType.ORTHOGONAL
    description: str = ""

    @property
    def filter_length(self) -> int:
        return int(self.dec_lo.shape[0])

    @property
    def is_orthogonal(self) -> bool:
        return self.wavelet_type is WaveletType.ORTHOGONAL

    def validation_tolerance(self) -> float:
        """Per-wavelet perfect-reconstruction tolerance.

        The reference relaxes sym8/sym10/coif2/dmey because its hardcoded
        tables are rounded (``Wavelet.java:122-129``); our generated filters
        are machine-precision, so only the inherently-truncated Fourier
        families need slack (dmey ~1e-5 instead of the reference's 3e-3;
        Battle-Lemarié short truncations ~5e-2, still far tighter than the
        reference's 5-20% deviations).
        """
        if self.family == "BattleLemarie":
            return 5e-2
        if self.name == "dmey":
            return 1e-4
        return 1e-10

    def validate_perfect_reconstruction(self) -> bool:
        """Check PR conditions within tolerance (``Wavelet.java:118-162``).

        Orthogonal: sum(h) = sqrt(2), sum(h^2) = 1, QMF relation, even-shift
        orthogonality.  Biorthogonal: high-pass filters derive from the
        counterpart low-pass via the alternating-sign reversal.
        """
        tol = self.validation_tolerance()
        h = self.dec_lo
        g = self.dec_hi
        if h.size == 0 or g.shape != h.shape:
            return False
        if self.wavelet_type is WaveletType.ORTHOGONAL:
            if abs(h.sum() - math.sqrt(2.0)) > tol:
                return False
            if abs((h * h).sum() - 1.0) > tol:
                return False
            if np.max(np.abs(qmf_highpass(h) - g)) > tol:
                return False
            for k in range(2, h.shape[0], 2):
                if abs(np.dot(h[:-k], h[k:])) > tol:
                    return False
            return True
        if self.wavelet_type is WaveletType.BIORTHOGONAL:
            exp_gd = qmf_alternate(self.rec_lo)
            exp_gr = qmf_alternate(self.dec_lo)
            if self.dec_hi.shape != exp_gd.shape or self.rec_hi.shape != exp_gr.shape:
                return False
            return bool(
                np.max(np.abs(self.dec_hi - exp_gd)) <= tol
                and np.max(np.abs(self.rec_hi - exp_gr)) <= tol
            )
        return True


def orthogonal_wavelet(
    name: str,
    family: str,
    dec_lo: np.ndarray,
    vanishing_moments: int,
    description: str = "",
) -> DiscreteWavelet:
    """Build an orthogonal wavelet from its low-pass decomposition filter."""
    dec_lo = np.asarray(dec_lo, dtype=np.float64)
    dec_hi = qmf_highpass(dec_lo)
    # Orthogonal reconstruction filters equal decomposition filters; the
    # synthesis convolution's (t+l) indexing performs the time reversal
    # (OrthogonalWavelet.java:23-35).
    return DiscreteWavelet(
        name=name,
        family=family,
        dec_lo=dec_lo,
        dec_hi=dec_hi,
        rec_lo=dec_lo,
        rec_hi=dec_hi,
        vanishing_moments=vanishing_moments,
        wavelet_type=WaveletType.ORTHOGONAL,
        description=description,
    )


def biorthogonal_wavelet(
    name: str,
    family: str,
    dec_lo: np.ndarray,
    rec_lo: np.ndarray,
    vanishing_moments: int,
    description: str = "",
) -> DiscreteWavelet:
    """Build a biorthogonal wavelet from analysis/synthesis low-pass filters."""
    dec_lo = np.asarray(dec_lo, dtype=np.float64)
    rec_lo = np.asarray(rec_lo, dtype=np.float64)
    return DiscreteWavelet(
        name=name,
        family=family,
        dec_lo=dec_lo,
        dec_hi=qmf_alternate(rec_lo),
        rec_lo=rec_lo,
        rec_hi=qmf_alternate(dec_lo),
        vanishing_moments=vanishing_moments,
        wavelet_type=WaveletType.BIORTHOGONAL,
        description=description,
    )


@dataclasses.dataclass(frozen=True)
class ContinuousWavelet:
    """A continuous wavelet defined by its (possibly complex) mother function.

    Reference: ``api/ContinuousWavelet.java`` / ``ComplexContinuousWavelet.java``.
    ``psi`` evaluates the mother wavelet on a numpy array of time points and
    returns float64 or complex128 values; ``center_frequency`` and ``bandwidth``
    drive scale <-> frequency conversion and CWT support sizing.
    """

    name: str
    family: str
    psi: Callable[[np.ndarray], np.ndarray]
    center_frequency: float
    bandwidth: float
    is_complex: bool = False
    description: str = ""

    @property
    def wavelet_type(self) -> WaveletType:
        if self.is_complex:
            return WaveletType.COMPLEX_CONTINUOUS
        return WaveletType.CONTINUOUS


Wavelet = DiscreteWavelet | ContinuousWavelet

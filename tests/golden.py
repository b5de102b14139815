"""Golden numpy implementation of the reference MODWT semantics.

Straight-line numpy ports of the scalar kernels in
``/root/reference/vectorwave-core/.../wavelet/internal/ScalarOps.java:640-916``
and the cascade logic of ``MultiLevelMODWTTransform.java`` — deliberately slow
and explicit, used only as the equivalence oracle for the JAX/Pallas paths
(the analogue of the reference comparing SIMD kernels against ScalarOps).
"""

from __future__ import annotations

import math

import numpy as np

INV_SQRT2 = 1.0 / math.sqrt(2.0)


def symmetric_index(idx: int, n: int) -> int:
    """Half-point symmetric extension (MathUtils.symmetricBoundaryExtension)."""
    if 0 <= idx < n:
        return idx
    period = 2 * n
    idx = ((idx % period) + period) % period
    if idx >= n:
        idx = period - idx - 1
    return idx


def convolve_analysis(x, filt, spacing=1, boundary="periodic"):
    """W_t = sum_l f_l * x[(t - spacing*l)] with boundary extension."""
    n = len(x)
    out = np.zeros(n)
    for t in range(n):
        acc = 0.0
        for l, c in enumerate(filt):
            idx = t - spacing * l
            if boundary == "periodic":
                acc += c * x[idx % n]
            elif boundary == "zero":
                if 0 <= idx < n:
                    acc += c * x[idx]
            else:
                acc += c * x[symmetric_index(idx, n)]
        out[t] = acc
    return out


def convolve_synthesis(x, filt, spacing=1, boundary="periodic", sign=+1, offset=0):
    """X_t = sum_l f_l * x[t + sign*spacing*l + offset] with boundary extension."""
    n = len(x)
    out = np.zeros(n)
    for t in range(n):
        acc = 0.0
        for l, c in enumerate(filt):
            idx = t + sign * spacing * l + offset
            if boundary == "periodic":
                acc += c * x[idx % n]
            elif boundary == "zero":
                if 0 <= idx < n:
                    acc += c * x[idx]
            else:
                acc += c * x[symmetric_index(idx, n)]
        out[t] = acc
    return out


def modwt_golden(x, w, boundary="periodic"):
    """Single-level forward (MODWTTransform.forward)."""
    low = w.dec_lo * INV_SQRT2
    high = w.dec_hi * INV_SQRT2
    return (
        convolve_analysis(x, low, 1, boundary),
        convolve_analysis(x, high, 1, boundary),
    )


def imodwt_golden(approx, detail, w, boundary="periodic"):
    """Single-level inverse (MODWTTransform.inverse)."""
    low = w.rec_lo * INV_SQRT2
    high = w.rec_hi * INV_SQRT2
    if boundary == "symmetric":
        # symmetric single-level inverse uses (t - l) indexing
        return convolve_synthesis(approx, low, 1, boundary, sign=-1) + convolve_synthesis(
            detail, high, 1, boundary, sign=-1
        )
    return convolve_synthesis(approx, low, 1, boundary) + convolve_synthesis(
        detail, high, 1, boundary
    )


def modwt_multilevel_golden(x, w, levels, boundary="periodic"):
    """Cascade decomposition (MultiLevelMODWTTransform.decompose)."""
    low = w.dec_lo * INV_SQRT2
    high = w.dec_hi * INV_SQRT2
    details = []
    current = np.asarray(x, dtype=np.float64)
    for level in range(1, levels + 1):
        spacing = 1 << (level - 1)
        details.append(convolve_analysis(current, high, spacing, boundary))
        current = convolve_analysis(current, low, spacing, boundary)
    return details, current


def imodwt_multilevel_golden(details, approx, w, boundary="periodic"):
    """Cascade reconstruction for periodic/zero boundaries
    (MultiLevelMODWTTransform.reconstruct): adjoint (t + spacing*l) reads."""
    low = w.rec_lo * INV_SQRT2
    high = w.rec_hi * INV_SQRT2
    current = np.asarray(approx, dtype=np.float64)
    for level in range(len(details), 0, -1):
        spacing = 1 << (level - 1)
        current = convolve_synthesis(
            current, low, spacing, boundary
        ) + convolve_synthesis(details[level - 1], high, spacing, boundary)
    return current


def denoise_multilevel_golden(x, w, levels, boundary="periodic", mode="soft"):
    """Universal-threshold multi-level denoise (WaveletDenoiser.
    denoiseMultiLevel): sigma = median|d_1| / 0.6745, level-j threshold
    sigma / sqrt(2^j) * sqrt(2 ln N), shrink the details, reconstruct."""
    details, approx = modwt_multilevel_golden(x, w, levels, boundary)
    n = len(x)
    sigma = np.median(np.abs(details[0])) / 0.6745
    shrunk = []
    for level, d in enumerate(details, start=1):
        t = sigma / math.sqrt(2.0**level) * math.sqrt(2.0 * math.log(n))
        if mode == "soft":
            shrunk.append(np.sign(d) * np.maximum(np.abs(d) - t, 0.0))
        else:
            shrunk.append(np.where(np.abs(d) > t, d, 0.0))
    return imodwt_multilevel_golden(shrunk, approx, w, boundary)

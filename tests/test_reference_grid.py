"""The public multi-level MODWT, its inverse and the denoiser against the
slow NumPy float64 golden cascade (tests/golden.py), over a grid of
wavelet x boundary x levels.  float32 input is checked to float32 rounding;
the grid covers orthogonal, least-asymmetric, coiflet and biorthogonal
filters."""

import jax.numpy as jnp
import numpy as np
import pytest

import vectorwave_tpu as vw

from .golden import (
    denoise_multilevel_golden,
    imodwt_multilevel_golden,
    modwt_multilevel_golden,
)

WAVELETS = ("haar", "db4", "sym8", "coif2", "bior2.2")
N = 128


def _signal(seed, n=N):
    return np.random.default_rng(seed).standard_normal(n)


@pytest.mark.parametrize("levels", [1, 3])
@pytest.mark.parametrize("boundary", ["periodic", "zero", "symmetric"])
@pytest.mark.parametrize("name", WAVELETS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_analysis_matches_golden(name, boundary, levels, dtype):
    w = vw.wavelet(name)
    x = _signal(levels).astype(dtype)
    res = vw.modwt_multilevel(jnp.asarray(x), name, levels=levels,
                              boundary=boundary)
    assert res.approx.dtype == jnp.dtype(dtype)
    details, approx = modwt_multilevel_golden(x.astype(np.float64), w, levels,
                                              boundary)
    tol = 2e-6 if dtype == "float32" else 1e-13
    for got, want in zip(res.details + (res.approx,), tuple(details) + (approx,)):
        np.testing.assert_allclose(np.asarray(got, np.float64), want, atol=tol)


@pytest.mark.parametrize("levels", [1, 3])
@pytest.mark.parametrize("boundary", ["periodic", "zero"])
@pytest.mark.parametrize("name", WAVELETS)
def test_synthesis_matches_golden(name, boundary, levels):
    w = vw.wavelet(name)
    rng = np.random.default_rng(10 + levels)
    details = [rng.standard_normal(N) for _ in range(levels)]
    approx = rng.standard_normal(N)
    got = vw.imodwt_multilevel(
        vw.MultiLevelMODWTResult(
            tuple(jnp.asarray(d) for d in details), jnp.asarray(approx)
        ),
        name, boundary=boundary,
    )
    want = imodwt_multilevel_golden(details, approx, w, boundary)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-13)


@pytest.mark.parametrize("name", WAVELETS)
def test_periodic_roundtrip_float32(name):
    x = jnp.asarray(_signal(3, 1024), jnp.float32)
    res = vw.modwt_multilevel(x, name, levels=4)
    xr = vw.imodwt_multilevel(res, name)
    err = np.asarray(xr, np.float64) - np.asarray(x, np.float64)
    assert float(np.sqrt(np.mean(err**2))) < 1e-6


@pytest.mark.parametrize("mode", ["soft", "hard"])
@pytest.mark.parametrize("boundary", ["periodic", "zero"])
@pytest.mark.parametrize("name", ("db4", "sym8", "coif2"))
def test_denoise_matches_golden(name, boundary, mode):
    w = vw.wavelet(name)
    x = np.sin(np.arange(N) / 5.0) + 0.3 * _signal(7)
    got = vw.denoise_multilevel(jnp.asarray(x), name, levels=3,
                                boundary=boundary, mode=mode)
    want = denoise_multilevel_golden(x, w, 3, boundary, mode)
    # the sort-free median (ops.thresholds.median_magnitude) searches
    # float32 bit patterns, so sigma — hence every threshold — is float32
    # grade even for float64 input
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-7)


@pytest.mark.parametrize("n,spacing", [(8, 4), (12, 4), (64, 4), (40, 16)])
@pytest.mark.parametrize("sign", [-1, +1])
def test_symmetric_convolution_matches_golden(n, spacing, sign):
    """Symmetric views are a symmetric pad, reflected repeatedly where the
    filter's reach is wider than the signal; it must equal the golden
    half-point extension (reaches here: 28 and 120 samples)."""
    from vectorwave_tpu.ops.convolve import atrous_convolve

    from .golden import convolve_analysis, convolve_synthesis

    w = vw.wavelet("db4")
    x = _signal(n, n)
    got = atrous_convolve(jnp.asarray(x), w.dec_lo, spacing=spacing,
                          boundary="symmetric", sign=sign)
    if sign < 0:
        want = convolve_analysis(x, w.dec_lo, spacing, "symmetric")
        from vectorwave_tpu.ops.convolve import atrous_analysis_pair

        lo, hi = atrous_analysis_pair(jnp.asarray(x), w.dec_lo, w.dec_hi,
                                      spacing=spacing, boundary="symmetric")
        np.testing.assert_allclose(np.asarray(lo), want, atol=1e-13)
        np.testing.assert_allclose(
            np.asarray(hi),
            convolve_analysis(x, w.dec_hi, spacing, "symmetric"), atol=1e-13,
        )
    else:
        want = convolve_synthesis(x, w.dec_lo, spacing, "symmetric", sign=+1)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-13)

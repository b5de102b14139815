"""Exact tier: the <=1e-10 contract through the float64 cascade.

The reference meets its 1e-12 parity gates in-process with Java doubles
(ModwtPeriodicRoundTripTest.java:37, MODWTPercivalWaldenValidationTest.java:
29-30).  ``precision='exact'`` (or a tolerance below the float32 floor)
upcasts float32 input and runs the cascade in float64; these tests pin that
grade against the slow NumPy golden oracle and the reconstruction contract.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import vectorwave_tpu as vw
from vectorwave_tpu.transforms.modwt import _resolve_discrete

from .golden import convolve_synthesis, modwt_multilevel_golden


def _rmse(a, b):
    err = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return float(np.sqrt(np.mean(err**2)))


@pytest.mark.parametrize("wavelet,levels", [("db4", 4), ("sym8", 3)])
def test_exact_roundtrip_below_1e10(wavelet, levels):
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((2, 1024)), dtype=jnp.float32)
    res = vw.modwt_multilevel(x, wavelet, levels=levels, precision="exact")
    assert res.approx.dtype == jnp.float64
    assert all(d.dtype == jnp.float64 for d in res.details)
    xr = vw.imodwt_multilevel(res, wavelet, precision="exact")
    assert xr.dtype == jnp.float64
    assert _rmse(xr, x) < 1e-12


def test_exact_analysis_matches_f64_cascade():
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.standard_normal(256), dtype=jnp.float32)
    w = _resolve_discrete("db4")
    res = vw.modwt_multilevel(x, w, levels=3, precision="exact")
    details, approx = modwt_multilevel_golden(np.asarray(x, np.float64), w, 3)
    for got, want in zip(res.details + (res.approx,), tuple(details) + (approx,)):
        np.testing.assert_allclose(np.asarray(got), want, atol=1e-13)


def test_exact_synthesis_inverts_exact_analysis_zero_boundary():
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((1, 512)), dtype=jnp.float32)
    w = _resolve_discrete("db4")
    res = vw.modwt_multilevel(x, w, levels=2, boundary="zero",
                              precision="exact")
    xr = vw.imodwt_multilevel(res, w, boundary="zero", precision="exact")
    # zero boundary: interior samples (beyond the filter span) reconstruct
    span = (w.filter_length - 1) * (2**2 - 1)
    got = np.asarray(xr)[:, span:-span]
    ref = np.asarray(x, np.float64)[:, span:-span]
    np.testing.assert_allclose(got, ref, atol=1e-12)
    # and the last level matches the golden zero-boundary synthesis
    low = w.rec_lo / np.sqrt(2.0)
    high = w.rec_hi / np.sqrt(2.0)
    a1 = vw.modwt_multilevel(x[0], w, levels=1, boundary="zero",
                             precision="exact")
    want = (convolve_synthesis(np.asarray(a1.approx), low, 1, "zero")
            + convolve_synthesis(np.asarray(a1.details[0]), high, 1, "zero"))
    got1 = vw.imodwt_multilevel(a1, w, boundary="zero", precision="exact")
    np.testing.assert_allclose(np.asarray(got1), want, atol=1e-13)


def test_public_exact_api_roundtrip_below_1e10():
    """``tolerance=1e-10`` on the public pair: batched and 1-D inputs."""
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.standard_normal((2, 2048)), jnp.float32)
    res = vw.modwt_multilevel(x, "db4", levels=4, tolerance=1e-10)
    assert len(res.details) == 4
    xr = vw.imodwt_multilevel(res, "db4", tolerance=1e-10)
    assert _rmse(xr, x) <= 1e-10
    r1 = vw.modwt_multilevel(x[0], "sym8", levels=3, tolerance=1e-10)
    x1 = vw.imodwt_multilevel(r1, "sym8", tolerance=1e-10)
    assert x1.shape == x[0].shape
    assert _rmse(x1, x[0]) <= 1e-10


def test_exact_symmetric_analysis_matches_f64():
    """Exact symmetric analysis == the golden mirrored cascade."""
    rng = np.random.default_rng(3)
    x32 = jnp.asarray(rng.standard_normal(256), jnp.float32)
    w = _resolve_discrete("db4")
    res = vw.modwt_multilevel(x32, w, levels=3, boundary="symmetric",
                              precision="exact")
    details, approx = modwt_multilevel_golden(
        np.asarray(x32, np.float64), w, 3, boundary="symmetric"
    )
    for got, want in zip(res.details + (res.approx,), tuple(details) + (approx,)):
        np.testing.assert_allclose(np.asarray(got), want, atol=1e-13)


@pytest.mark.parametrize(
    "kwargs", [{"precision": "exact"}, {"tolerance": 1e-10}],
    ids=["precision", "tolerance"],
)
def test_exact_tier_without_x64_raises(kwargs):
    """Without 64-bit mode the exact tier cannot exist: it says so instead
    of quietly returning float32 planes."""
    x = np.zeros(256, np.float32)
    with jax.enable_x64(False):
        with pytest.raises(vw.InvalidArgumentError, match="jax_enable_x64"):
            vw.modwt_multilevel(jnp.asarray(x), "db4", levels=2, **kwargs)
        # the float32 tier is still served
        res = vw.modwt_multilevel(jnp.asarray(x), "db4", levels=2,
                                  precision="float32")
        assert res.approx.dtype == jnp.float32

"""Tolerance-driven precision routing on the default API.

The reference's public API is f64 end-to-end and its default round trip
meets <1e-9 max error (ModwtPeriodicRoundTripTest.java:37); ours makes that
contract reachable via ``modwt_multilevel(x, w, tolerance=...)`` without
knowing the tier names.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import vectorwave_tpu as vw


def test_resolve_tolerance_ladder():
    assert vw.resolve_tolerance(0.5) == "float32"
    assert vw.resolve_tolerance(1e-3) == "float32"
    assert vw.resolve_tolerance(3e-6) == "float32"
    assert vw.resolve_tolerance(1e-5) == "float32"
    assert vw.resolve_tolerance(2.9e-6) == "exact"
    assert vw.resolve_tolerance(1e-10) == "exact"
    with pytest.raises(vw.InvalidArgumentError):
        vw.resolve_tolerance(0.0)


def test_tolerance_1e10_roundtrip_meets_contract():
    """The reference's default-path accuracy, from the default API."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((2, 4096)), jnp.float32)
    res = vw.modwt_multilevel(x, "db4", levels=5, tolerance=1e-10)
    assert isinstance(res, vw.MultiLevelMODWTResult)
    assert res.approx.dtype == jnp.float64
    # coefficient parity vs the f64 oracle
    x64 = jnp.asarray(np.asarray(x, np.float64))
    ref = vw.modwt_multilevel(x64, "db4", levels=5, backend="jnp")
    for got, want in zip(res.details + (res.approx,), ref.details + (ref.approx,)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-14)
    xr = vw.imodwt_multilevel(res, "db4")
    assert xr.dtype == jnp.float64
    err = np.asarray(xr, np.float64) - np.asarray(x, np.float64)
    assert float(np.sqrt(np.mean(err**2))) <= 1e-10


def test_precision_kwarg_explicit():
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal(4096), jnp.float32)
    res = vw.modwt_multilevel(x, "sym8", levels=3, precision="exact")
    assert res.approx.dtype == jnp.float64
    res32 = vw.modwt_multilevel(x, "sym8", levels=3, precision="float32")
    assert res32.approx.dtype == jnp.float32
    for removed in ("fp8", "bf16", "bf16_3x"):
        with pytest.raises(vw.InvalidArgumentError):
            vw.modwt_multilevel(x, "sym8", levels=3, precision=removed)


def test_exact_tier_batched_leading_dims():
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((2, 3, 2048)), jnp.float32)
    res = vw.modwt_multilevel(x, "db4", levels=3, tolerance=1e-10)
    assert res.approx.shape == x.shape
    xr = vw.imodwt_multilevel(res, "db4")
    err = np.asarray(xr, np.float64) - np.asarray(x, np.float64)
    assert float(np.sqrt(np.mean(err**2))) <= 1e-10


def test_plain_result_with_exact_tolerance_raises():
    """Planes already rounded to f32 — the inverse cannot un-round them."""
    x = jnp.zeros((2, 4096), jnp.float32)
    res = vw.modwt_multilevel(x, "db4", levels=3)
    with pytest.raises(vw.InvalidArgumentError, match="float64 planes"):
        vw.imodwt_multilevel(res, "db4", tolerance=1e-10)


def test_exact_result_symmetric_inverse_raises():
    """The exact tier has no symmetric inverse (docs/API.md): the
    alignment-shifted symmetric inverse is a boundary approximation."""
    x = jnp.zeros((2, 2048), jnp.float32)
    res = vw.modwt_multilevel(x, "db4", levels=3, precision="exact",
                              boundary="symmetric")
    assert res.approx.dtype == jnp.float64
    with pytest.raises(vw.InvalidArgumentError, match="symmetric"):
        vw.imodwt_multilevel(res, "db4", boundary="symmetric",
                             precision="exact")


def test_f64_input_short_circuits_exact_tier():
    """An f64 signal on the CPU backend is already exact-grade — the
    router keeps the jnp path and still meets the tolerance."""
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal(4096), jnp.float64)
    res = vw.modwt_multilevel(x, "db4", levels=4, tolerance=1e-10)
    assert isinstance(res, vw.MultiLevelMODWTResult)
    assert res.approx.dtype == jnp.float64
    xr = vw.imodwt_multilevel(res, "db4", tolerance=1e-10)
    err = np.asarray(xr, np.float64) - np.asarray(x, np.float64)
    assert float(np.sqrt(np.mean(err**2))) <= 1e-10


def test_denoise_tolerance_clamps_to_f32_floor():
    """Denoise output is f32; sub-f32 tolerances serve the float32 tier
    (documented) and must run without error."""
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.standard_normal((2, 4096)), jnp.float32)
    out = vw.denoise_multilevel(x, "db4", levels=4, tolerance=1e-10)
    ref = vw.denoise_multilevel(x, "db4", levels=4, precision="float32")
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=0)


def test_tolerance_below_1e11_escalates_to_full_profile():
    """tolerance<=1e-11 is served by the same float64 cascade — the
    coefficient parity sits at the float64 floor."""
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((2, 2048)), jnp.float32)
    res = vw.modwt_multilevel(x, "db4", levels=4, tolerance=1e-12)
    x64 = jnp.asarray(np.asarray(x, np.float64))
    ref = vw.modwt_multilevel(x64, "db4", levels=4, backend="jnp")
    for got, want in zip(res.details + (res.approx,), ref.details + (ref.approx,)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=2e-12)
    xr = vw.imodwt_multilevel(res, "db4", tolerance=1e-12)
    err = np.asarray(xr, np.float64) - np.asarray(x, np.float64)
    assert float(np.max(np.abs(err))) <= 1e-12


def test_denoise_explicit_exact_precision_raises():
    """A NAMED precision='exact' request on the denoise surface cannot be
    honored (f32 output floor) — it must raise, not silently substitute."""
    x = jnp.zeros((2, 4096), jnp.float32)
    with pytest.raises(vw.InvalidArgumentError, match="float32 tier"):
        vw.denoise_multilevel(x, "db4", levels=4, precision="exact")

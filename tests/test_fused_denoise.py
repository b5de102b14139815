"""Multi-level denoise against the float64 oracle.

``denoise_multilevel`` is analysis -> per-level shrink with sigma/sqrt(2^j)
scaling -> reconstruction (reference semantics, WaveletDenoiser.java:
155-171).  The oracle runs the same public pieces in float64; the float32
path must agree to float32 rounding, values and gradients alike.
"""

import jax
import numpy as np
import jax.numpy as jnp
import pytest

import vectorwave_tpu as vw
from vectorwave_tpu.ops.thresholds import (
    apply_threshold,
    mad_sigma,
    universal_threshold,
)
from vectorwave_tpu.transforms.multilevel import MultiLevelMODWTResult


def _thresholds(res, n, levels):
    sigma = mad_sigma(res.details[0])
    return jnp.concatenate(
        [universal_threshold(n, sigma / jnp.sqrt(2.0**j))
         for j in range(1, levels + 1)],
        axis=-1,
    )


def _oracle(x, name, levels, boundary, mode):
    """Three public calls in float64 with the thresholds made explicit."""
    x64 = jnp.asarray(np.asarray(x, np.float64))
    n = x64.shape[-1]
    res = vw.modwt_multilevel(x64, name, levels=levels, boundary=boundary)
    ths = _thresholds(res, n, levels)
    nd = tuple(
        apply_threshold(d, ths[..., j:j + 1], mode)
        for j, d in enumerate(res.details)
    )
    return vw.imodwt_multilevel(
        MultiLevelMODWTResult(nd, res.approx), name, boundary=boundary,
    )


@pytest.mark.parametrize(
    "b,n,name,levels,boundary,mode",
    [
        (2, 2048, "db4", 4, "periodic", "soft"),
        (1, 4096, "sym8", 3, "zero", "soft"),
        (1, 4096, "sym8", 3, "zero", "hard"),
        (3, 4096, "haar", 5, "periodic", "soft"),
        (2, 2048, "bior2.2", 3, "periodic", "soft"),
    ],
)
def test_fused_denoise_matches_three_call_path(b, n, name, levels, boundary,
                                               mode):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((b, n)), jnp.float32)
    got = vw.denoise_multilevel(x, name, levels=levels, boundary=boundary,
                                method="universal", mode=mode)
    assert got.dtype == jnp.float32 and got.shape == x.shape
    ref = _oracle(x, name, levels, boundary, mode)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=5e-6)


def test_fused_denoise_short_signal_falls_back():
    """Short signals take the same path and keep oracle parity."""
    x = jnp.asarray(np.random.default_rng(7).standard_normal((1, 512)),
                    jnp.float32)
    got = vw.denoise_multilevel(x, "haar", levels=5)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(_oracle(x, "haar", 5, "periodic", "soft")),
        atol=5e-6,
    )


def test_fused_denoise_symmetric_falls_back():
    x = jnp.asarray(np.random.default_rng(8).standard_normal((1, 4096)),
                    jnp.float32)
    got = vw.denoise_multilevel(x, "db4", levels=3, boundary="symmetric")
    np.testing.assert_allclose(
        np.asarray(got),
        np.asarray(_oracle(x, "db4", 3, "symmetric", "soft")),
        atol=5e-6,
    )


def test_public_api_routes_and_matches():
    """'auto' and 'jnp' are one path (identical output); the removed
    'pallas' kernel tier is rejected."""
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((2, 4096)), jnp.float32)
    ref = vw.denoise_multilevel(x, "db4", levels=4, method="universal",
                                mode="soft")
    vw.set_backend("jnp")
    try:
        got = vw.denoise_multilevel(x, "db4", levels=4, method="universal",
                                    mode="soft")
    finally:
        vw.set_backend("auto")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    with pytest.raises(vw.InvalidConfigurationError):
        vw.set_backend("pallas")
    assert vw.get_backend() == "auto"


def test_fused_denoise_gradients_match_jnp_path():
    """jax.grad of a denoising loss in float32 must match float64, for the
    input and through the thresholds' own dependence on x (the sort-free
    median's custom JVP)."""
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((2, 2048)), jnp.float32)
    n = 2048

    def loss(y):
        out = vw.denoise_multilevel(y, "db4", levels=3, method="universal",
                                    mode="soft")
        w_ = jnp.arange(n, dtype=y.dtype)
        return jnp.sum(out**2 * w_)

    g32 = jax.grad(loss)(x)
    g64 = jax.grad(loss)(x.astype(jnp.float64))
    scale = float(jnp.max(jnp.abs(g64)))
    np.testing.assert_allclose(np.asarray(g32), np.asarray(g64),
                               atol=3e-6 * scale)


def test_public_denoise_grad_end_to_end():
    """jax.grad(denoise_multilevel) is finite and matches central finite
    differences in float64 (the API guarantee 'every transform is
    differentiable')."""
    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.standard_normal(2048), jnp.float64)

    def loss(y):
        return jnp.sum(
            vw.denoise_multilevel(y, "db4", levels=3, method="universal",
                                  mode="soft") ** 2
        )

    g = jax.grad(loss)(x)
    assert bool(jnp.all(jnp.isfinite(g)))
    eps = 1e-6
    for i in (11, 700, 2000):
        fd = (loss(x.at[i].add(eps)) - loss(x.at[i].add(-eps))) / (2 * eps)
        assert abs(float(g[i]) - float(fd)) < 1e-5 * max(1.0, abs(float(fd)))


def test_median_magnitude_matches_jnp_median_bitexact():
    """The sort-free bitwise order-statistic median must equal jnp.median
    of |v| exactly (it feeds mad_sigma, hence every denoise threshold)."""
    from vectorwave_tpu.ops.thresholds import median_magnitude

    rng = np.random.default_rng(3)
    for shape in [(3, 1024), (1, 65536), (5, 999), (2, 7), (4, 2), (1, 1)]:
        v = jnp.asarray(
            rng.standard_normal(shape) * rng.lognormal(0, 3, shape),
            jnp.float32,
        )
        got = np.asarray(median_magnitude(v))
        want = np.asarray(jnp.median(jnp.abs(v), axis=-1, keepdims=True))
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        np.asarray(median_magnitude(jnp.zeros((2, 8)))), np.zeros((2, 1))
    )


def test_sure_method_keeps_materializing_path():
    """SURE needs the detail planes and runs through the same cascade."""
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal(2048), jnp.float32)
    out = vw.denoise_multilevel(x, "db4", levels=3, method="sure",
                                mode="soft")
    assert out.shape == x.shape and bool(jnp.all(jnp.isfinite(out)))


@pytest.mark.slow
def test_fused_denoise_property_sweep_across_families():
    """float32-vs-float64 parity across a spread of the registry
    (orthogonal, least-asymmetric, coiflet, biorthogonal, long filters) x
    modes x boundaries."""
    rng = np.random.default_rng(9)
    cases = [
        ("db2", "periodic", "soft"), ("db8", "zero", "hard"),
        ("sym12", "periodic", "hard"), ("coif3", "zero", "soft"),
        ("bior4.4", "periodic", "soft"), ("rbio2.2", "periodic", "hard"),
        ("db16", "periodic", "soft"), ("coif5", "periodic", "soft"),
    ]
    for name, boundary, mode in cases:
        n, levels = 4096, 3
        x = jnp.asarray(rng.standard_normal((1, n)), jnp.float32)
        got = vw.denoise_multilevel(x, name, levels=levels,
                                    boundary=boundary, mode=mode)
        ref = _oracle(x, name, levels, boundary, mode)
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(ref), atol=2e-5,
            err_msg=f"{name} {boundary} {mode}",
        )

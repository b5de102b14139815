"""Differentiability: gradients flow through every transform tier.

A capability beyond the reference (Java, non-differentiable): wavelet-domain
losses can train upstream models.  The analysis map is linear, and its
adjoint is the synthesis structure with the analysis filters, so the float32
gradients must match the float64 ones and finite differences.
"""

import jax
import jax.numpy as jnp
import numpy as np

import vectorwave_tpu as vw
from .conftest import composite_sin


def _x32(shape, seed=0):
    return jnp.asarray(
        np.random.default_rng(seed).standard_normal(shape), dtype=jnp.float32
    )


def test_grad_through_jnp_modwt():
    x = jnp.asarray(composite_sin(256))

    def loss(x):
        res = vw.modwt_multilevel(x, "db4", levels=3)
        return sum((d**2).sum() for d in res.details)

    g = jax.grad(loss)(x)
    assert np.isfinite(np.asarray(g)).all()
    # loss = ||Px||^2 for a linear projector-ish map: grad = 2 A^T A x, finite diff check
    eps = 1e-6
    i = 100
    fd = (loss(x.at[i].add(eps)) - loss(x.at[i].add(-eps))) / (2 * eps)
    assert abs(float(g[i]) - float(fd)) < 1e-4


def test_pallas_analysis_vjp_matches_jnp():
    """float32 analysis gradient == the float64 one (the adjoint rule)."""
    x = _x32((2, 1024))

    def loss(x):
        res = vw.modwt_multilevel(x, "db4", levels=4)
        return sum((dd**2).sum() for dd in res.details) * 0.5 + 0.25 * (
            res.approx**2
        ).sum()

    g1 = jax.grad(loss)(x)
    g2 = jax.grad(loss)(x.astype(jnp.float64))
    assert g1.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), atol=5e-6)


def test_pallas_synthesis_vjp_matches_jnp():
    """float32 synthesis gradients == the float64 ones, every plane."""
    x = _x32((2, 1024), seed=1)
    res = vw.modwt_multilevel(x, "db4", levels=3)

    def loss_syn(details, approx):
        out = vw.imodwt_multilevel(
            vw.MultiLevelMODWTResult(details, approx), "db4"
        )
        return (out**2).sum()

    ga = jax.grad(loss_syn, argnums=(0, 1))(tuple(res.details), res.approx)
    gb = jax.grad(loss_syn, argnums=(0, 1))(
        tuple(d.astype(jnp.float64) for d in res.details),
        res.approx.astype(jnp.float64),
    )
    for a, b in zip(ga[0], gb[0]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=5e-6)
    np.testing.assert_allclose(np.asarray(ga[1]), np.asarray(gb[1]), atol=5e-6)


def test_biorthogonal_pallas_vjp_finite_difference():
    """dec != rec: the adjoint must use the forward map's own filters."""
    x = _x32((1, 512), seed=2).astype(jnp.float64)

    def loss(x):
        res = vw.modwt_multilevel(x, "bior2.2", levels=2)
        d, a = res.details, res.approx
        return (d[0] ** 2).sum() + (d[1] * 2).sum() + (a**2).sum()

    g = jax.grad(loss)(x)
    eps = 1e-4
    for i in (37, 137, 400):
        fd = (loss(x.at[0, i].add(eps)) - loss(x.at[0, i].add(-eps))) / (2 * eps)
        assert abs(float(g[0, i]) - float(fd)) < 1e-6


def test_grad_through_denoiser():
    """End-to-end: gradient of a denoising loss w.r.t. the noisy input."""
    x = jnp.asarray(composite_sin(256, noise_std=0.3))

    def loss(x):
        den = vw.denoise_multilevel(x, "db4", levels=3, method="universal")
        return ((den - x) ** 2).mean()

    g = jax.grad(loss)(x)
    assert np.isfinite(np.asarray(g)).all()
    assert float(jnp.abs(g).max()) > 0


def test_grad_through_cwt():
    x = jnp.asarray(composite_sin(256))

    def loss(x):
        res = vw.cwt(x, (4.0, 8.0, 16.0), "morl")
        return (res.coeffs**2).sum()

    g = jax.grad(loss)(x)
    assert np.isfinite(np.asarray(g)).all()

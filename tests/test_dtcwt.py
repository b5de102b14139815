"""Dual-tree complex wavelet transform: generated q-shift filters, perfect
reconstruction, near-shift-invariance, analyticity."""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp

import vectorwave_tpu as vw
from vectorwave_tpu.errors import VectorWaveError
from vectorwave_tpu.ops.dwt import wavedec, waverec
from vectorwave_tpu.transforms.dtcwt import DTCWTResult
from vectorwave_tpu.wavelets.qshift import qshift_filters


def test_qshift_filters_exactly_orthonormal():
    h, g = qshift_filters()
    assert len(h) == 14
    # generated through the paraunitary lattice: these hold to float64 eps
    assert abs(h.sum() - np.sqrt(2)) < 1e-12
    assert abs((h * h).sum() - 1.0) < 1e-12
    for k in range(2, 14, 2):
        assert abs(np.dot(h[:-k], h[k:])) < 1e-12
        assert abs(np.dot(g[:-k], g[k:])) < 1e-12
    assert abs(np.dot(h, g)) < 1e-12  # cross-orthogonality at zero shift
    # exact vanishing moment (sum(theta)=pi/4 constraint)
    assert abs((h * (-1.0) ** np.arange(14)).sum()) < 1e-12


def test_qshift_quarter_sample_delay():
    h, _ = qshift_filters()
    w = np.linspace(0.05, 0.45 * np.pi, 200)
    spec = np.exp(-1j * np.outer(w, np.arange(14))) @ h
    tau = 13 / 2 - 0.25
    # phase deviation from the ideal fractional delay, passband
    dev = np.abs(np.angle(spec * np.exp(1j * w * tau)))
    assert dev.max() < 0.06  # radians


@pytest.mark.slow
@pytest.mark.parametrize("levels", [1, 3, 5])
@pytest.mark.parametrize("shape", [(512,), (3, 512)])
def test_perfect_reconstruction(levels, shape):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(shape).astype(np.float32))
    res = vw.dtcwt(x, levels=levels)
    xr = vw.idtcwt(res)
    assert float(jnp.max(jnp.abs(xr - x))) < 1e-5
    assert res.highpasses[0].shape == shape[:-1] + (shape[-1] // 2,)
    assert jnp.iscomplexobj(res.highpasses[0])


def test_energy_identity():
    # |z_j|^2 averages the two trees, each orthonormal: total energy of
    # highpasses + mean of the two lowpass energies equals ||x||^2
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal(1024))
    res = vw.dtcwt(x, levels=4)
    total = sum(float(jnp.sum(jnp.abs(z) ** 2)) for z in res.highpasses)
    total += 0.5 * float(
        jnp.sum(res.lowpass_a**2) + jnp.sum(res.lowpass_b**2)
    )
    assert total == pytest.approx(float(jnp.sum(x**2)), rel=1e-5)


def _recon_level(x, j, levels=4):
    res = vw.dtcwt(jnp.asarray(x), levels=levels)
    hp = tuple(
        z if k == j - 1 else jnp.zeros_like(z)
        for k, z in enumerate(res.highpasses)
    )
    return np.asarray(
        vw.idtcwt(
            DTCWTResult(
                hp,
                jnp.zeros_like(res.lowpass_a),
                jnp.zeros_like(res.lowpass_b),
            )
        )
    )


def _recon_level_dwt(x, j, levels=4):
    dec = wavedec(jnp.asarray(x), "sym8", levels=levels)
    det = tuple(
        d if k == j - 1 else jnp.zeros_like(d)
        for k, d in enumerate(dec.details)
    )
    return np.asarray(
        waverec(
            dec._replace(details=det, approx=jnp.zeros_like(dec.approx)),
            "sym8",
        )
    )


@pytest.mark.slow
def test_near_shift_invariance_vs_dwt():
    """The DTCWT's reason to exist: per-level reconstruction commutes with
    shifts far better than the critically-sampled DWT."""
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal(256)
    for j, bound in ((2, 0.12), (3, 0.25), (4, 0.25)):
        base = _recon_level(x0, j)
        base_d = _recon_level_dwt(x0, j)
        dev = max(
            np.linalg.norm(
                _recon_level(np.roll(x0, s), j) - np.roll(base, s)
            )
            / np.linalg.norm(base)
            for s in range(1, 9)
        )
        dev_dwt = max(
            np.linalg.norm(
                _recon_level_dwt(np.roll(x0, s), j) - np.roll(base_d, s)
            )
            / np.linalg.norm(base_d)
            for s in range(1, 9)
        )
        assert dev < bound, (j, dev)
        assert dev_dwt > 3 * dev, (j, dev, dev_dwt)


def test_magnitude_envelope_smooth_for_tone():
    """Analyticity in practice: |z| of a pure tone is a near-constant
    envelope (the DWT's real coefficients oscillate through zero)."""
    t = np.arange(1024)
    tone = np.cos(2 * np.pi * 0.04 * t)  # scale ~ level 3-4
    res = vw.dtcwt(jnp.asarray(tone), levels=5)
    energies = [float(jnp.sum(jnp.abs(z) ** 2)) for z in res.highpasses]
    j = int(np.argmax(energies)) + 1
    mag = np.asarray(jnp.abs(res.highpasses[j - 1]))[16:-16]
    ripple = (mag.max() - mag.min()) / mag.mean()
    assert ripple < 0.25
    # the same level's DWT detail passes through zero (ripple ~ 2)
    dec = wavedec(jnp.asarray(tone), "sym8", levels=5)
    mag_dwt = np.abs(np.asarray(dec.details[j - 1]))[16:-16]
    assert (mag_dwt.max() - mag_dwt.min()) / mag_dwt.mean() > 1.0


def test_coefficient_delay_aligns_features():
    # an isolated burst's envelope peak should land at its position once
    # the accumulated group delay is rolled off
    n = 1024
    pos = 400
    x = np.zeros(n, np.float32)
    t = np.arange(n)
    x = (np.exp(-0.5 * ((t - pos) / 30.0) ** 2) * np.cos(2 * np.pi * 0.05 * t)).astype(
        np.float32
    )
    res = vw.dtcwt(jnp.asarray(x), levels=5)
    energies = [float(jnp.sum(jnp.abs(z) ** 2)) for z in res.highpasses]
    j = int(np.argmax(energies)) + 1
    mag = np.asarray(jnp.abs(res.highpasses[j - 1]))
    shift = round(vw.coefficient_delay(j))
    peak = (int(np.argmax(np.roll(mag, shift))) * (1 << j)) % 1024
    assert abs(peak - pos) <= 2 * (1 << j)


def test_validation_and_max_levels():
    assert vw.dtcwt_max_levels(1024) == 6
    with pytest.raises(VectorWaveError):
        vw.dtcwt(jnp.zeros(100), levels=3)  # 100 not divisible by 8
    with pytest.raises(VectorWaveError):
        vw.dtcwt(jnp.zeros(64), levels=0)
    with pytest.raises(VectorWaveError):
        vw.dtcwt(jnp.zeros(64), "bior2.2", levels=2)  # not orthogonal



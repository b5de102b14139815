"""chip_smoke.py rehearsed on the CPU at tiny sizes.

Each phase function runs here with its comparison logic; ``main`` must
refuse the CPU (non-zero exit, no result line).  The card itself is reached
only by the ``gpu``-marked test, which decides inside a fixture.
"""

import jax
import numpy as np
import pytest

import chip_smoke as cs

from .golden import modwt_multilevel_golden


@pytest.fixture
def small_signal():
    return cs.make_signal(8, 1024)


@pytest.fixture
def gpu_devices():
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip(f"needs a GPU; this backend is {devices[0].platform!r}")
    return devices


def test_phase_roundtrip_small(small_signal):
    out = cs.phase_roundtrip(small_signal, reps=1)
    assert out["rmse"] <= cs.TOL_RT_RMSE
    assert out["coeff_max_abs"] <= cs.TOL_COEFF
    assert out["compile_s"] > 0 and out["step_s"] > 0


def test_phase_denoise_small(small_signal):
    out = cs.phase_denoise(small_signal, reps=1)
    assert out["max_abs"] <= cs.TOL_DENOISE


def test_phase_cwt_small():
    x1 = cs.make_signal(1, 1 << 14, seed=1)[0]
    out = cs.phase_cwt(x1, cs.cwt_scales(8, 1024.0), reps=1)
    assert out["max_rel"] <= cs.TOL_CWT_REL


def test_phase_exact_small(small_signal):
    out = cs.phase_exact(small_signal, reps=1)
    assert out["rmse"] <= cs.TOL_EXACT_RMSE
    assert out["coeff_max_abs"] <= cs.TOL_EXACT_COEFF


def test_phase_multi_on_four_virtual_devices(small_signal, capsys):
    devices = jax.devices()[:4]
    assert len(devices) == 4
    cs.phase_multi(small_signal, devices)
    printed = capsys.readouterr().out
    for d in devices:
        assert str(d) in printed  # per-device placement is reported


def test_check_raises_past_its_limit(capsys):
    cs.check("within", 1e-7, 1e-6)
    with pytest.raises(cs.CheckFailed):
        cs.check("beyond", 2e-6, 1e-6)
    assert "FAILED" in capsys.readouterr().out


def test_main_refuses_the_cpu(capsys):
    assert cs.main([]) != 0
    assert cs.main(["--multi"]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_numpy_reference_matches_golden_cascade():
    """The script's vectorised NumPy reference == the slow golden loops."""
    import vectorwave_tpu as vw

    x = np.random.default_rng(2).standard_normal((2, 128))
    details, approx = cs.np_modwt(x, cs.DB4_LOW, 3)
    w = vw.wavelet("db4")
    for row in range(2):
        gd, ga = modwt_multilevel_golden(x[row], w, 3)
        for got, want in zip(details + [approx], gd + [ga]):
            np.testing.assert_allclose(got[row], want, atol=1e-11)
    np.testing.assert_allclose(cs.np_imodwt(details, approx, cs.DB4_LOW), x,
                               atol=1e-11)


def test_numpy_morlet_unit_energy_and_matches_registry():
    import vectorwave_tpu as vw

    t = np.linspace(-64.0, 64.0, 1 << 16)
    v = cs.np_morlet(t)
    assert abs(float(np.trapezoid(v * v, t)) - 1.0) < 1e-12
    np.testing.assert_allclose(vw.wavelet("morl").psi(t), v, atol=1e-14)


@pytest.mark.gpu
def test_chip_smoke_full_size_on_gpu(gpu_devices):
    """The whole one-card smoke run at its real sizes (card only)."""
    assert cs.main([]) == 0

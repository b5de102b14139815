"""Infrastructure parity: ops facade, cost model, observability, padding config,
MODWT-based inverse CWT."""

import jax.numpy as jnp
import numpy as np
import pytest

import vectorwave_tpu as vw
from vectorwave_tpu import cost_model, observability
from vectorwave_tpu.ops import facade
from .conftest import composite_sin


def test_facade_convolutions_match_ops():
    x = jnp.asarray(composite_sin(256))
    w = vw.wavelet("db4")
    filt = w.dec_lo / np.sqrt(2.0)
    a = facade.circular_convolve_modwt(x, filt)
    res = vw.modwt(x, "db4")
    np.testing.assert_allclose(np.asarray(a), np.asarray(res.approx), atol=1e-12)
    z = facade.zero_padding_convolve_modwt(x, filt)
    s = facade.symmetric_convolve_modwt(x, filt)
    assert z.shape == s.shape == x.shape


def test_facade_fft_routing():
    assert not facade.should_use_fft(512, 64)  # small N
    assert not facade.should_use_fft(2048, 8)  # short filter
    assert facade.should_use_fft(1024, 256)  # long filter vs N
    # FFT path equals direct path for periodic convolution
    x = jnp.asarray(composite_sin(1024))
    w = vw.wavelet("dmey")
    filt = w.dec_lo / np.sqrt(2.0)
    from vectorwave_tpu.ops.convolve import atrous_convolve, fft_circular_convolve

    direct = atrous_convolve(x, filt, boundary="periodic")
    via_fft = fft_circular_convolve(x, filt)
    np.testing.assert_allclose(np.asarray(direct), np.asarray(via_fft), atol=1e-9)


def test_performance_info():
    info = facade.get_performance_info()
    assert info.platform in ("cpu", "gpu")
    assert info.device_count >= 1
    assert "compute tier" in info.description


def test_cost_model_estimate_and_calibration(tmp_path, monkeypatch):
    monkeypatch.setenv("VECTORWAVE_TPU_CACHE", str(tmp_path))
    with pytest.raises(vw.InvalidStateError, match="calibrate"):
        cost_model.estimate_processing_time(65536, levels=6, batch=8)
    rate = cost_model.calibrate(sizes=(1024,), batch=2, levels=3, persist=True)
    assert rate > 0
    pred = cost_model.estimate_processing_time(65536, levels=6, batch=8)
    assert pred.estimated_seconds > 0
    assert pred.lower_seconds < pred.estimated_seconds < pred.upper_seconds
    # work scales linearly with the batch at the calibrated rate
    pred2 = cost_model.estimate_processing_time(65536, levels=6, batch=16)
    assert pred2.estimated_seconds == pytest.approx(2 * pred.estimated_seconds)


def test_observability_stats_and_meter():
    observability.stats.reset()
    with observability.throughput_meter("unit", samples=1000):
        pass
    snap = observability.stats.snapshot()
    assert snap["unit.samples"] == 1000
    assert snap["unit.seconds"] >= 0
    observability.stats.reset()
    assert observability.stats.get("unit.samples") == 0


def test_modwt_based_icwt():
    from vectorwave_tpu.transforms.cwt_modwt_inverse import modwt_based_icwt

    n = 1024
    t = np.arange(n)
    x = np.sin(2 * np.pi * t / 32) + 0.5 * np.sin(2 * np.pi * t / 128)
    scales = vw.scales_log(2, 256, 48)
    res = vw.cwt(jnp.asarray(x), scales, "morl", boundary="periodic")
    # reconstruct with the approx band supplied from a MODWT of the signal
    ref = vw.modwt_multilevel(jnp.asarray(x), "sym4", levels=5)
    xr = np.asarray(modwt_based_icwt(res, "morl", approx=ref.approx))
    nrmse = np.sqrt(np.mean((xr - x) ** 2)) / np.std(x)
    # reference documents 3-10% error for this reconstruction route
    assert nrmse < 0.15, nrmse


def test_transform_config_dataclass():
    cfg = vw.TransformConfig(boundary="zero", backend="jnp")
    assert cfg.boundary == "zero"
    assert cfg.max_decomposition_levels == 20


def test_fft_routing_is_wired_into_modwt():
    """Round-1 finding: should_use_fft was dead code.  Now modwt() and
    modwt_multilevel() route long-filter periodic transforms through
    fft_analysis_pair, with the crossover measured on chip (>= 64 base taps;
    tools/probe_fft_crossover.py)."""
    import numpy as np

    import vectorwave_tpu as vw
    from vectorwave_tpu.ops import facade

    # dmey (62 taps) stays on the roll path per the measurement
    assert not facade.should_use_fft(65536, 62)
    assert facade.should_use_fft(65536, 64)

    # a custom 80-tap orthonormal-ish filter routes through FFT and matches
    # the roll form
    rng = np.random.default_rng(0)
    taps = rng.standard_normal(80)
    taps /= np.sqrt((taps**2).sum()) / np.sqrt(2)
    from vectorwave_tpu.wavelets.base import orthogonal_wavelet

    w = orthogonal_wavelet("test_long80", "custom", taps, 0)
    x = jnp.asarray(composite_sin(4096, noise_std=0.2))
    res_fft = vw.modwt(x, w, boundary="periodic")  # routes via FFT (80 >= 64)
    from vectorwave_tpu.ops.convolve import atrous_analysis_pair

    a, d = atrous_analysis_pair(
        x, w.dec_lo / np.sqrt(2), w.dec_hi / np.sqrt(2), spacing=1,
        boundary="periodic",
    )
    np.testing.assert_allclose(np.asarray(res_fft.approx), np.asarray(a), atol=1e-9)
    np.testing.assert_allclose(np.asarray(res_fft.detail), np.asarray(d), atol=1e-9)


def test_validation_edge_cases():
    """Structured errors for degenerate inputs (ValidationUtils analogue)."""
    import jax.numpy as jnp
    import pytest

    import vectorwave_tpu as vw
    from vectorwave_tpu.streaming import streaming_init

    with pytest.raises(vw.InvalidArgumentError):
        vw.cwt(jnp.ones(64), (), "morl")  # no scales
    with pytest.raises(vw.InvalidSignalError):
        vw.cwt(jnp.zeros(0), (2.0,), "morl")  # empty signal
    with pytest.raises(vw.InvalidArgumentError):
        streaming_init("db4", 0)  # levels < 1
    with pytest.raises(vw.InvalidArgumentError):
        streaming_init("db4", -3)

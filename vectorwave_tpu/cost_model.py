"""Static cost model + optional on-device calibration.

Re-design of the reference's runtime-learning subsystem
(``/root/reference/vectorwave-core/.../wavelet/performance/`` —
``AdaptivePerformanceEstimator.java:19-243``, ``PerformanceCalibrator.java``,
``PerformanceModel``, ``ConfidenceInterval``): there is nothing to "learn"
per call — XLA compiles a fixed program — so the estimator reduces to a
roofline-style model (work / sustained throughput) whose single free
parameter, sustained throughput, is measured once per device kind by an
explicit :func:`calibrate` microbenchmark and persisted to the cache
directory (the analogue of ``~/.vectorwave/performance``,
docs/RUNTIME_LEARNING.md).  There are no built-in rates: a device that was
never calibrated is an error, not a guess.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

@dataclasses.dataclass(frozen=True)
class PredictionResult:
    """Estimate + confidence interval (performance/PredictionResult,
    ConfidenceInterval; MODWTTransform.estimateProcessingTime :344-364)."""

    estimated_seconds: float
    lower_seconds: float
    upper_seconds: float


def _store_path() -> str:
    from .config import cache_root

    root = cache_root()
    os.makedirs(root, exist_ok=True)
    return os.path.join(root, "performance.json")


def _load_store() -> dict:
    try:
        with open(_store_path()) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return {}


def _save_store(store: dict) -> None:
    try:
        with open(_store_path(), "w") as fh:
            json.dump(store, fh)
    except OSError:
        pass


def _platform_key() -> str:
    dev = jax.devices()[0]
    return f"{dev.platform}:{dev.device_kind}"


def estimate_processing_time(
    signal_length: int,
    *,
    levels: int = 6,
    batch: int = 1,
    filter_length: int = 8,
) -> PredictionResult:
    """Predict a multi-level round-trip's wall time.

    Model: work scales with batch * N * levels * filter_length; the sustained
    rate is the one :func:`calibrate` measured on this ``platform:device_kind``
    (the reference's confidence-interval API around it).  Raises
    :class:`InvalidStateError` when this device kind was never calibrated.
    """
    key = _platform_key()
    entry = _load_store().get(key)
    if not entry:
        from .errors import ErrorCode, InvalidStateError

        raise InvalidStateError(
            ErrorCode.STATE_INVALID,
            f"No calibrated throughput for device {key!r}",
            suggestions=("Run vectorwave_tpu.cost_model.calibrate() once on "
                         "this device",),
        )
    work = batch * signal_length * levels * filter_length / (6 * 8)
    est = work / entry["samples_per_second"]
    return PredictionResult(est, est * 0.7, est * 1.5)


def calibrate(
    *,
    sizes: tuple[int, ...] = (16384, 65536),
    batch: int = 8,
    levels: int = 6,
    wavelet: str = "db4",
    persist: bool = True,
) -> float:
    """Measure sustained round-trip throughput on the current device and
    persist it (PerformanceCalibrator.runCalibration; opt-in like
    ``vectorwave.perf.calibration``).  Returns samples/sec."""
    from .transforms.multilevel import imodwt_multilevel, modwt_multilevel

    dev = jax.devices()[0]
    use_f64 = dev.platform == "cpu" and jax.config.jax_enable_x64
    dtype = jnp.float64 if use_f64 else jnp.float32
    rates = []
    for n in sizes:
        x = jnp.asarray(
            np.random.default_rng(0).standard_normal((batch, n)), dtype=dtype
        )

        def rt(x):
            res = modwt_multilevel(x, wavelet, levels=levels)
            return imodwt_multilevel(res, wavelet)

        fn = jax.jit(rt)
        fn(x).block_until_ready()
        iters = 10
        start = time.perf_counter()
        for _ in range(iters):
            out = fn(x)
        out.block_until_ready()
        elapsed = time.perf_counter() - start
        rates.append(batch * n * iters / elapsed)
    rate = float(np.median(rates))
    if persist:
        store = _load_store()
        store[_platform_key()] = {
            "samples_per_second": rate,
            "levels": levels,
            "wavelet": wavelet,
            "timestamp": time.time(),
        }
        _save_store(store)
    return rate

"""Test configuration: CPU backend with 8 virtual devices + float64.

Mirrors the reference's test strategy (SURVEY.md §4): correctness is defined in
double precision; multi-chip sharding is validated on a virtual CPU mesh
(``xla_force_host_platform_device_count``), the analogue of the reference's
single-process parallel-vs-sequential equivalence tests.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest

from vectorwave_tpu.config import enable_compilation_cache

enable_compilation_cache()


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def composite_sin(n: int, seed: int = 7, noise_std: float = 0.0) -> np.ndarray:
    """Seeded composite-sinusoid generator (reference: testing/TestSignals.java:18-30)."""
    t = np.arange(n)
    x = (
        np.sin(2 * np.pi * t / 32.0)
        + 0.5 * np.sin(2 * np.pi * t / 8.0)
        + 0.25 * np.sin(2 * np.pi * t / 128.0 + 0.6)
    )
    if noise_std > 0:
        x = x + np.random.default_rng(seed).normal(0.0, noise_std, n)
    return x

"""Sharded exact (<=1e-10) tier: the tiled transform on float64 input.

The exact tier is the float64 cascade; sharding it over the signal axis
with ring halo exchange must keep the single-device parity contract.
Oracle: the f64 transform on the unsharded signal.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import vectorwave_tpu as vw
from vectorwave_tpu.parallel import (
    imodwt_multilevel_tiled,
    make_mesh,
    modwt_multilevel_tiled,
)


@pytest.fixture(scope="module")
def signal_mesh():
    return make_mesh({"signal": 8})


def _x64(n, seed):
    x32 = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    return jnp.asarray(x32.astype(np.float64))


def test_tiled_exact_roundtrip_below_1e10(signal_mesh):
    x = _x64(8192, 0)
    res = modwt_multilevel_tiled(x, "db4", levels=4, mesh=signal_mesh)
    assert res.approx.dtype == jnp.float64
    xr = imodwt_multilevel_tiled(res, "db4", mesh=signal_mesh)
    err = np.asarray(xr) - np.asarray(x)
    rmse = float(np.sqrt(np.mean(err**2)))
    assert rmse <= 1e-10, rmse


def test_tiled_exact_matches_f64_oracle(signal_mesh):
    """Sharded float64 analysis == single-device f64 planes to ~1e-13."""
    x = _x64(4096, 1)
    tiled = modwt_multilevel_tiled(x, "sym8", levels=3, mesh=signal_mesh)
    ref = vw.modwt_multilevel(x, "sym8", levels=3, boundary="periodic")
    for got, want in zip(tiled.details + (tiled.approx,),
                         ref.details + (ref.approx,)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-13)


def test_tiled_exact_zero_boundary(signal_mesh):
    x = _x64(4096, 2)
    tiled = modwt_multilevel_tiled(x, "db4", levels=3, mesh=signal_mesh,
                                   boundary="zero")
    ref = vw.modwt_multilevel(x, "db4", levels=3, boundary="zero")
    for got, want in zip(tiled.details + (tiled.approx,),
                         ref.details + (ref.approx,)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-13)


def test_tiled_exact_multi_wrap_periodic(signal_mesh):
    """Cumulative span >= the whole signal: the periodic extension wraps
    more than once across the ring, and the hop chain must still match
    the f64 oracle and round-trip below 1e-10."""
    levels = 6
    n = 1024  # db8 span = 15 * 63 = 945 samples > 128 per shard
    x = _x64(n, 4)
    tiled = modwt_multilevel_tiled(x, "db8", levels=levels, mesh=signal_mesh)
    ref = vw.modwt_multilevel(x, "db8", levels=levels, boundary="periodic")
    for got, want in zip(tiled.details + (tiled.approx,),
                         ref.details + (ref.approx,)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-12)
    xr = imodwt_multilevel_tiled(tiled, "db8", mesh=signal_mesh)
    err = np.asarray(xr) - np.asarray(x)
    assert float(np.sqrt(np.mean(err**2))) <= 1e-10

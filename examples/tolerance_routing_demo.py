"""Tolerance-driven precision routing (docs/API.md "Accuracy").

The reference's public API is f64 end-to-end and its default round trip
meets <1e-9 max error (ModwtPeriodicRoundTripTest.java:37).  Here the
same contract is requested with a number, not a tier name:
``modwt_multilevel(x, w, tolerance=1e-10)`` routes to the exact tier, which
runs the cascade in float64 (it needs ``jax_enable_x64``).
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np
import jax
import jax.numpy as jnp

import vectorwave_tpu as vw

jax.config.update("jax_enable_x64", True)


def main():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((4, 4096)), jnp.float32)

    for tol in (1e-2, 1e-5, 1e-10):
        tier = vw.resolve_tolerance(tol)
        res = vw.modwt_multilevel(x, "db4", levels=5, tolerance=tol)
        xr = vw.imodwt_multilevel(res, "db4", tolerance=tol)
        err = np.asarray(xr, np.float64) - np.asarray(x, np.float64)
        rmse = float(np.sqrt(np.mean(err ** 2)))
        print(f"tolerance {tol:g}: tier={tier:8s} planes={res.approx.dtype} "
              f"round-trip rmse {rmse:.2e}")
        assert rmse <= tol, (tol, rmse)

    # without 64-bit mode the exact tier refuses instead of returning float32
    with jax.enable_x64(False):
        try:
            vw.modwt_multilevel(x, "db4", levels=5, tolerance=1e-10)
        except vw.InvalidArgumentError as exc:
            print(f"without x64: {str(exc).splitlines()[0]}")


if __name__ == "__main__":
    main()

"""Multi-host layouts: DCN-free work splits over a ("host", "chip") mesh.

Beyond the reference's scope (its widest unit is one JVM): place the work
so the slow inter-host network carries ZERO bytes during the transform —
batch over hosts for the MODWT, scales over hosts for the CWT — while the
per-level halo exchange rides the fast intra-slice interconnect.
Run: python examples/multihost_demo.py
(simulates 2 hosts x 4 chips on the virtual CPU mesh; in a real
multi-controller run the same code maps hosts to actual processes.)
"""

import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

if "--xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    )

import jax

if len(jax.devices()) < 8:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

import vectorwave_tpu as vw
from vectorwave_tpu.parallel import (
    communication_report,
    cwt_tiled_2d,
    imodwt_multilevel_multihost,
    make_multihost_mesh,
    modwt_multilevel_multihost,
)


def main() -> None:
    mesh = make_multihost_mesh(n_hosts=2, chips_per_host=4)
    print(f"mesh: {dict(mesh.shape)} over {mesh.devices.size} devices")

    # MODWT: batch shards over "host", each signal tiles over "chip".
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((4, 4096)), dtype=jnp.float32)
    res = modwt_multilevel_multihost(x, "db4", levels=4, mesh=mesh)
    xr = imodwt_multilevel_multihost(res, "db4", mesh=mesh)
    single = vw.modwt_multilevel(x, "db4", levels=4)
    err = float(jnp.max(jnp.abs(res.approx - single.approx)))
    print(f"MODWT parity vs single-device: {err:.2e}; "
          f"round trip: {float(jnp.max(jnp.abs(xr - x))):.2e}")
    print(f"output sharding: {res.approx.sharding.spec}")

    # The analytic communication model: exact bytes per chip per transform.
    rep = communication_report(mesh, "db4", levels=4, n=4096, batch=4)
    print(f"halo bytes/chip: {rep.halo_bytes_per_chip}  "
          f"bytes between hosts: {rep.host_bytes_per_host}  "
          f"comm/compute: {rep.halo_fraction_of_compute_bytes:.4f}")

    # CWT: scales shard over "host" (embarrassingly parallel), signal tiles
    # over "chip" — the 64-scale-on-1M-samples layout at demo size.
    sig = jnp.asarray(rng.standard_normal(4096), dtype=jnp.float32)
    scales = vw.scales_log(2.0, 32.0, 16)
    spec2d = cwt_tiled_2d(sig, scales, "morl", mesh=mesh)
    ref = vw.cwt(sig, scales, "morl", boundary="zero")
    cerr = float(jnp.max(jnp.abs(spec2d.coeffs - ref.coeffs)))
    print(f"CWT 2-axis parity vs single-device: {cerr:.2e}; "
          f"coeffs sharded {spec2d.coeffs.sharding.spec}")


if __name__ == "__main__":
    main()

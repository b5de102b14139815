"""Distributed transforms over a device mesh (runs on the virtual CPU mesh).

The multi-chip story: batch sharding (data parallel), long-signal tiling
with ppermute halo exchange (sequence parallel), and scale/signal-parallel
CWT — all bit-identical to the single-device transforms.
Run: python examples/distributed_demo.py
(sets up an 8-device virtual CPU mesh when fewer devices are attached; on
real cards the same code runs over the physical mesh.)
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
    imodwt_multilevel_tiled,
    make_mesh,
    modwt_multilevel_sharded_batch,
    modwt_multilevel_tiled,
)
from vectorwave_tpu.parallel.cwt_tiled import cwt_tiled


def main() -> None:
    devices = jax.devices()
    if len(devices) < 8:
        devices = jax.devices("cpu")
    rng = np.random.default_rng(0)

    # --- long-signal tiling: one 64K signal across 8 devices ---------------
    mesh = make_mesh({"signal": 8}, devices=devices[:8])
    x = jnp.asarray(rng.standard_normal(16384), dtype=jnp.float32)
    res = modwt_multilevel_tiled(
        x, "db4", levels=4, mesh=mesh, boundary="symmetric"
    )
    single = vw.modwt_multilevel(x, "db4", levels=4, boundary="symmetric")
    dev = float(jnp.max(jnp.abs(res.approx - single.approx)))
    print(f"tiled symmetric analysis vs single-device: {dev:.2e}")
    xr = imodwt_multilevel_tiled(res, "db4", mesh=mesh, boundary="symmetric")
    xr_single = vw.imodwt_multilevel(single, "db4", boundary="symmetric")
    print(
        "tiled symmetric inverse vs single-device: "
        f"{float(jnp.max(jnp.abs(xr - xr_single))):.2e}"
    )

    # --- batch sharding: 16 signals over a data axis -----------------------
    mesh2 = make_mesh({"data": 8}, devices=devices[:8])
    batch = jnp.asarray(rng.standard_normal((16, 4096)), dtype=jnp.float32)
    res_b = modwt_multilevel_sharded_batch(
        batch, "db4", levels=4, mesh=mesh2, axis="data"
    )
    energies = res_b.relative_energy_distribution()
    print(f"sharded batch energies shape: {tuple(energies.shape)}")

    # --- distributed CWT: signal tiled, scales batched ---------------------
    y = jnp.asarray(rng.standard_normal(8192), dtype=jnp.float32)
    spec = cwt_tiled(
        y, vw.scales_log(2, 64, 16), "morl", mesh=mesh, boundary="zero"
    )
    ref = vw.cwt(y, vw.scales_log(2, 64, 16), "morl", boundary="zero")
    print(
        "tiled CWT vs single-device: "
        f"{float(jnp.max(jnp.abs(spec.coeffs - ref.coeffs))):.2e}"
    )


if __name__ == "__main__":
    main()

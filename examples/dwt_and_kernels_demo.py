"""Decimated DWT pyramid: perfect reconstruction and the energy split.

Run: python examples/dwt_and_kernels_demo.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax.numpy as jnp
import numpy as np

import vectorwave_tpu as vw


def main() -> None:
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(1024), dtype=jnp.float32)

    # --- decimated pyramid: coefficients halve per level -------------------
    dec = vw.wavedec(x, "db4", levels=4)
    shapes = [tuple(d.shape) for d in dec.details] + [tuple(dec.approx.shape)]
    print(f"wavedec shapes (d1..d4, a4): {shapes}")
    xr = vw.waverec(dec, "db4")
    print(f"pyramid round-trip error: {float(jnp.max(jnp.abs(x - xr))):.2e}")

    # biorthogonal pairs reconstruct exactly too (parity-calibrated offsets)
    res = vw.dwt(x, "bior4.4")
    xr_b = vw.idwt(res.approx, res.detail, "bior4.4")
    print(f"bior4.4 PR error: {float(jnp.max(jnp.abs(x - xr_b))):.2e}")

    # DWT coefficients relate to MODWT by subsampling x sqrt(2) scaling at
    # matching phase — both transforms agree on signal energy split
    e_dwt = float((res.approx**2).sum() + (res.detail**2).sum())
    print(f"orthogonal-energy check (db4): {abs(e_dwt / float((x**2).sum()) - 1):.2e}")


if __name__ == "__main__":
    main()

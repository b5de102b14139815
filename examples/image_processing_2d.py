"""2-D wavelet processing: subband analysis and image denoising.

Beyond the reference's (1-D only) scope: the separable 2-D transforms are
two batched 1-D passes per level.  Decompose a synthetic
image into oriented subbands, then denoise it.
Run: python examples/image_processing_2d.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax.numpy as jnp
import numpy as np

import vectorwave_tpu as vw

H = W = 128


def synthetic_image(rng: np.random.Generator) -> np.ndarray:
    yy, xx = np.mgrid[0:H, 0:W]
    img = np.sin(2 * np.pi * yy / 24) + np.cos(2 * np.pi * xx / 16)
    img[H // 2 :, :] += 1.5   # horizontal edge
    img[:, W // 2 :] += 0.75  # vertical edge
    return img


def main() -> None:
    rng = np.random.default_rng(4)
    clean = synthetic_image(rng)
    noisy = clean + 0.4 * rng.standard_normal((H, W))
    x = jnp.asarray(noisy)

    # Subband energies: hl sees horizontal edges (high along rows), lh
    # vertical ones, hh diagonals.
    res = vw.modwt2(x, "haar")
    for name, band in zip(("ll", "lh", "hl", "hh"), res):
        print(f"{name} energy: {float((band**2).sum()):10.1f}")

    # Multi-level + exact reconstruction (periodic).
    ml = vw.modwt2_multilevel(x, "sym4", levels=3)
    back = vw.imodwt2_multilevel(ml, "sym4")
    print(f"3-level round trip max err: {float(jnp.max(jnp.abs(back - x))):.2e}")

    # Denoise: per-level, per-subband thresholds (finest hh estimates noise).
    den = np.asarray(vw.denoise2(x, "sym4", levels=3, method="universal"))
    rmse_noisy = float(np.sqrt(np.mean((noisy - clean) ** 2)))
    rmse_den = float(np.sqrt(np.mean((den - clean) ** 2)))
    print(f"denoise2 RMSE: {rmse_noisy:.3f} -> {rmse_den:.3f}")

    # 2-D SWT facade + multi-resolution analysis: additive per-scale
    # images that sum back to the input (periodic).
    bands = vw.mra2(x, "db4", levels=3)
    total = sum(np.asarray(b) for b in bands)
    print(f"mra2: {len(bands)} bands, additivity err "
          f"{float(np.abs(total - np.asarray(x)).max()):.2e}")

    # Decimated pyramid: L-shaped coefficient layout, exact reconstruction.
    details, ll = vw.wavedec2(x, "db2", levels=3)
    print(f"wavedec2: ll {ll.shape}, finest detail {details[0][0].shape}")
    rec = vw.waverec2(details, ll, "db2")
    print(f"wavedec2 round trip max err: {float(jnp.max(jnp.abs(rec - x))):.2e}")


if __name__ == "__main__":
    main()

"""GPU latencies for the second wave of beyond-reference modules.

Companion to tools/perf_beyond.py (same on-device fori-chain timing — each
workload is iterated ON-DEVICE with the output folded back into the carry).
Every chain carries a real array.

Measures:
  * DTCWT 1-D roundtrip (8 x 16384, 5 levels, generated q-shift filters)
  * DTCWT 2-D roundtrip (512 x 512, 4 levels)
  * cwt2 scale x orientation bank (256 x 256, 8 scales x 8 angles)
  * scattering1d order-2 features (8 x 16384, J=6 Q=8)
  * scattering2d order-2 features (128 x 128, J=3 L=6)
  * EWT roundtrip (16384, 4 adaptive bands, fixed boundaries)
  * synchrosqueeze (32 scales x 16384)
  * multifractal_spectrum (1M samples, wavelet leaders + WLS fits)
  * inpaint (512 samples, 40% missing, 200 FISTA iterations — one solve)

Run: python tools/perf_beyond2.py (needs a GPU; prints the card and one
JSON line).
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def _measure(fn, x, iters=150, reps=3):
    @jax.jit
    def repeat(y):
        return jax.lax.fori_loop(0, iters, lambda _, z: fn(z), y)

    jax.block_until_ready(repeat(x))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(repeat(x))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) / iters * 1e3  # ms


def main() -> int:
    import vectorwave_tpu as vw

    vw.enable_compilation_cache()
    if jax.devices()[0].platform != "gpu":
        print("needs a GPU", file=sys.stderr)
        return 1
    from vectorwave_tpu.observability import card_description

    print(f"card: {card_description()}", flush=True)
    from vectorwave_tpu.transforms.cwt import scales_log

    dev = jax.devices()[0]
    rng = np.random.default_rng(0)
    out: dict[str, float | str] = {"device": dev.device_kind}

    # 1. DTCWT 1-D roundtrip, 8 x 16384, 5 levels
    x1 = jnp.asarray(rng.standard_normal((8, 16384)), jnp.float32)
    t = _measure(lambda z: vw.idtcwt(vw.dtcwt(z, levels=5)), x1)
    out["dtcwt5_roundtrip_8x16384_ms"] = t
    out["dtcwt5_msamples_per_s"] = 8 * 16384 / (t / 1e3) / 1e6
    x1b = jnp.asarray(rng.standard_normal((64, 16384)), jnp.float32)
    tb = _measure(lambda z: vw.idtcwt(vw.dtcwt(z, levels=5)), x1b, iters=100)
    out["dtcwt5_roundtrip_64x16384_ms"] = tb
    out["dtcwt5_msamples_per_s_64"] = 64 * 16384 / (tb / 1e3) / 1e6

    # 2. DTCWT 2-D roundtrip, 512 x 512, 4 levels
    x2 = jnp.asarray(rng.standard_normal((512, 512)), jnp.float32)
    t = _measure(lambda z: vw.idtcwt2(vw.dtcwt2(z, levels=4)), x2, iters=100)
    out["dtcwt2_roundtrip_512x512_ms"] = t

    # 2b. 2-D MODWT roundtrip, 8 x 2048 x 2048 db4 J=4
    x2b = jnp.asarray(rng.standard_normal((8, 2048, 2048)), jnp.float32)

    def m2rt(z):
        res = vw.modwt2_multilevel(z, "db4", levels=4)
        return vw.imodwt2_multilevel(res, "db4")

    t = _measure(m2rt, x2b, iters=30)
    out["modwt2_roundtrip_8x2048_ms"] = t

    # 2c. deep-span + full-pipeline rows on the same images: db4 J=6
    # roundtrip and denoise2 (sigma + per-subband thresholds + synthesis)
    def m2rt6(z):
        res = vw.modwt2_multilevel(z, "db4", levels=6)
        return vw.imodwt2_multilevel(res, "db4")

    t = _measure(m2rt6, x2b, iters=5)
    out["modwt2_roundtrip_J6_8x2048_ms"] = t

    def dn2(z):
        return vw.denoise2(z, "db4", levels=4, method="universal",
                           mode="soft")

    t = _measure(dn2, x2b, iters=30)
    out["denoise2_8x2048_ms"] = t

    # 3. cwt2 bank, 256 x 256, 8 scales x 8 angles (complex stays on device)
    x3 = jnp.asarray(rng.standard_normal((256, 256)), jnp.float32)
    angles = tuple(np.linspace(0, np.pi, 8, endpoint=False))
    sc2 = tuple(np.geomspace(2, 32, 8))

    def cwt2_chain(z):
        r = vw.cwt2(z, sc2, "morl2", angles=angles)
        return z + 1e-20 * jnp.abs(r.coeffs).sum(axis=(-4, -3))

    out["cwt2_8x8_256x256_ms"] = _measure(cwt2_chain, x3, iters=100)

    # 4. scattering1d, 8 x 16384, J=6 Q=8 order-2
    def scat1_chain(z):
        r = vw.scattering1d(z, J=6, Q=8)
        return z + 1e-20 * r.feature_vector().sum(axis=-1, keepdims=True)

    out["scattering1d_8x16384_ms"] = _measure(scat1_chain, x1, iters=100)

    # 5. scattering2d, 128 x 128, J=3 L=6 order-2
    x5 = jnp.asarray(rng.standard_normal((128, 128)), jnp.float32)

    def scat2_chain(z):
        r = vw.scattering2d(z, J=3, L=6)
        return z + 1e-20 * r.feature_vector().sum(axis=-1, keepdims=True)[..., None]

    out["scattering2d_128x128_ms"] = _measure(scat2_chain, x5, iters=100)

    # 6. EWT roundtrip, 16384 samples, 4 bands (boundaries fixed / static)
    x6 = jnp.asarray(rng.standard_normal(16384), jnp.float32)
    bounds = (0.05, 0.15, 0.35)  # cycles/sample, in (0, 0.5)
    t = _measure(lambda z: vw.iewt(vw.ewt(z, bounds), bounds), x6)
    out["ewt_roundtrip_16384_ms"] = t

    # 7. synchrosqueeze, 32 scales x 16384
    scales = scales_log(2, 256, 32)

    def sst_chain(z):
        r = vw.synchrosqueeze(z, scales, "morl")
        return z + 1e-20 * jnp.abs(r.coeffs).sum(axis=-2)

    out["sst_32sc_16384_ms"] = _measure(sst_chain, x6, iters=100)

    # 8. multifractal spectrum, 1M samples
    x8 = jnp.asarray(rng.standard_normal(1 << 20), jnp.float32)

    def mf_chain(z):
        r = vw.multifractal_spectrum(z, "db3")
        return z + 1e-20 * r.zeta.sum()

    out["multifractal_1M_ms"] = _measure(mf_chain, x8, iters=30)

    # 9. inpaint 512 samples, 40% missing, 200 FISTA iterations (one solve)
    mask = jnp.asarray(rng.random(512) > 0.4, jnp.float32)
    x9 = jnp.asarray(rng.standard_normal(512), jnp.float32) * mask

    def inpaint_chain(z):
        return vw.inpaint(z, mask, "db8", steps=200) * mask

    out["inpaint_512_200it_ms"] = _measure(inpaint_chain, x9, iters=5)

    # 10. FISTA inpaint at 1M samples, 30% missing, 200 iterations (one
    # solve, at a production size)
    n10 = 1 << 20
    mask10 = jnp.asarray(rng.random(n10) > 0.3, jnp.float32)
    tt = np.arange(n10)
    smooth = (np.sin(2 * np.pi * tt / 4096) +
              0.4 * np.sin(2 * np.pi * tt / 512 + 1.0)).astype(np.float32)
    x10 = jnp.asarray(smooth) * mask10

    def inpaint1m_chain(z):
        return vw.inpaint(z, mask10, "db8", steps=200) * mask10

    out["inpaint_1M_200it_ms"] = _measure(inpaint1m_chain, x10, iters=2)

    # 11. packets2d best-basis denoise, 256x256 depth-3 — ONE jitted
    # program (on-device Coifman–Wickerhauser DP + masked reconstruction),
    # so the standard fori chain applies
    x11 = jnp.asarray(rng.standard_normal((256, 256)), jnp.float32)

    def pk2_denoise(z):
        return vw.best_basis_denoise2(
            z, "db4", 3, threshold=0.8, cost="shannon", cost_threshold=0.5,
            mode="soft",
        )

    out["packets2d_bestbasis_denoise_256_ms"] = _measure(
        pk2_denoise, x11, iters=100
    )

    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

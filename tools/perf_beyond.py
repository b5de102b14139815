"""GPU latencies for the beyond-reference analysis modules (wave 1).

Measures (on-device fori chains, see bench.py's timing discipline):
  * MODWPT depth-4 roundtrip (sym8) — packets hot path
  * wavelet_variance 6-level db4 on 1M samples
  * wavelet_coherence morl 32 scales x 32768
  * extract_ridge (Viterbi scan) on a 32 x 65536 scalogram

Run: python tools/perf_beyond.py (needs a GPU; prints the card and one
JSON line; tools/perf_beyond2.py measures the second wave).
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
    from vectorwave_tpu.transforms.cwt import cwt, scales_log
    from vectorwave_tpu.transforms.packets import imodwpt, modwpt

    dev = jax.devices()[0]
    rng = np.random.default_rng(0)
    out: dict[str, float] = {"device": dev.device_kind}

    # 1. MODWPT depth-4 roundtrip, batch 8 x 16384
    x1 = jnp.asarray(rng.standard_normal((8, 16384)), jnp.float32)
    t = _measure(lambda z: imodwpt(modwpt(z, "sym8", 4), "sym8"), x1)
    out["modwpt4_roundtrip_8x16384_ms"] = t
    out["modwpt4_msamples_per_s"] = 8 * 16384 / (t / 1e3) / 1e6
    # production-batch rate (tile-saturated; the 8x16K row is latency-class)
    x1b = jnp.asarray(rng.standard_normal((64, 16384)), jnp.float32)
    tb = _measure(lambda z: imodwpt(modwpt(z, "sym8", 4), "sym8"), x1b,
                  iters=100)
    out["modwpt4_roundtrip_64x16384_ms"] = tb
    out["modwpt4_msamples_per_s_64"] = 64 * 16384 / (tb / 1e3) / 1e6

    # 2. wavelet variance, 1M samples, 6 levels
    x2 = jnp.asarray(rng.standard_normal(1 << 20), jnp.float32)

    def var_chain(z):
        r = vw.wavelet_variance(z, "db4", 6)
        return z + 1e-20 * r.variance.sum()

    out["wavelet_variance_1M_6lvl_ms"] = _measure(var_chain, x2, iters=100)

    # 3. coherence, 32 scales x 32768
    n3 = 32768
    x3 = jnp.asarray(rng.standard_normal(n3), jnp.float32)
    y3 = jnp.asarray(rng.standard_normal(n3), jnp.float32)
    scales = scales_log(2, 256, 32)

    def coh_chain(z):
        c = vw.wavelet_coherence(z, y3, scales, "morl")
        return z + 1e-20 * c.coherence.mean(axis=-2)

    out["coherence_32sc_32768_ms"] = _measure(coh_chain, x3, iters=100)

    # 4. Viterbi ridge on a 32 x 65536 scalogram (carry the real magnitude:
    # ridge extraction only consumes |W|)
    x4 = jnp.asarray(rng.standard_normal(65536), jnp.float32)
    mag4 = jax.jit(
        lambda z: jnp.abs(cwt(z, scales, "morl", analytic=True).coeffs)
    )(x4)

    def ridge_chain(p):
        ridge = vw.extract_ridge(vw.CWTResult(p, scales, "zero"), smoothness=2.0)
        return p + (1e-20 * ridge.amplitude)[..., None, :]

    out["ridge_32sc_65536_ms"] = _measure(ridge_chain, mag4, iters=100)

    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

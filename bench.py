"""Benchmark: db4 6-level MODWT analysis+synthesis throughput (Msamples/sec/card).

Prints the card's name and power limit, then ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "device", ...extras}.

Headline config (#2 of BASELINE.json): db4, 6 levels, 65536 samples, batch
128, PERIODIC, float32, through the public ``modwt_multilevel`` ->
``imodwt_multilevel`` pair.  Extras: the round-trip RMSE and a measured copy
bandwidth, against which the round trip's minimum traffic (64 B/sample of
float32: x in, 7 planes out, 7 planes in, x_hat out) gives a
bandwidth-bound rate.

vs_baseline compares against the reference's CPU SIMD extensions
(BASELINE.md: 16K round-trip in 0.76 ms ~ 21.5 Msamples/s on a 24-core
AVX-512 CPU).

Needs a GPU: exits non-zero without one.  Run: ``python bench.py``.
"""

from __future__ import annotations

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

BASELINE_MSAMPLES_PER_SEC = 21.5  # reference SIMD ext (README.md:329)

WAVELET = "db4"
LEVELS = 6
N = 65536
BATCH = 128
ITERS = 50
ROUNDTRIP_BYTES_PER_SAMPLE = 64


def _measure(fn, x, iters=ITERS, reps=5):
    """Seconds per call, steady state: ``iters`` dependent calls chained on
    the device (the carry feeds the next call, so nothing is hoisted), the
    median of ``reps`` timed chains; compilation happens before timing."""
    @jax.jit
    def repeat(y):
        return jax.lax.fori_loop(0, iters, lambda _, z: fn(z), y)

    repeat(x).block_until_ready()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        repeat(x).block_until_ready()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) / iters


def _copy_bandwidth_gbps() -> float:
    """Measured device copy bandwidth: two independent dependent-carry
    streams of 256 MiB each (read 2, write 1 per stream per step).  The
    addends are arguments, not closure constants (XLA folds a uniform
    constant to a scalar, which halves the reads), and the optimization
    barrier keeps it from fusing several steps into one pass."""
    nbig = 64 * 1024 * 1024
    big = jnp.ones((nbig,), jnp.float32)
    addend1 = jnp.full((nbig,), 0.5, jnp.float32)
    addend2 = jnp.full((nbig,), 0.25, jnp.float32)
    steps = 100

    @jax.jit
    def chain(v, c1, c2):
        def body(_, ys):
            a, b = jax.lax.optimization_barrier(ys)
            return (a + c1) * 0.75, (b + c2) * 0.8

        return jax.lax.fori_loop(0, steps, body, (v, v * 0.9))

    jax.block_until_ready(chain(big, addend1, addend2))
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(chain(big, addend1, addend2))
        times.append(time.perf_counter() - t0)
    return steps * 6 * nbig * 4 / float(np.median(times)) / 1e9


def main() -> int:
    import vectorwave_tpu as vw
    from vectorwave_tpu.observability import card_description

    vw.enable_compilation_cache()
    device = jax.devices()[0]
    if device.platform != "gpu":
        print(f"bench: needs a GPU, found {device.platform!r}", file=sys.stderr)
        return 1
    card = card_description()
    print(f"card: {card}", flush=True)

    x = jnp.asarray(
        np.random.default_rng(0).standard_normal((BATCH, N)), jnp.float32
    )

    def rt(y):
        res = vw.modwt_multilevel(y, WAVELET, levels=LEVELS, boundary="periodic")
        return vw.imodwt_multilevel(res, WAVELET, boundary="periodic")

    t = _measure(rt, x)
    rate = BATCH * N / t / 1e6
    rmse = float(jnp.sqrt(jnp.mean((jax.jit(rt)(x) - x) ** 2)))
    bw = _copy_bandwidth_gbps()
    bound = bw * 1e9 / ROUNDTRIP_BYTES_PER_SAMPLE / 1e6
    result = {
        "metric": "modwt_db4_6level_roundtrip_throughput",
        "value": rate,
        "unit": "Msamples/sec/card",
        "vs_baseline": rate / BASELINE_MSAMPLES_PER_SEC,
        "device": {
            "platform": device.platform,
            "kind": device.device_kind,
            "count": len(jax.devices()),
        },
        "card": card,
        "config": f"{WAVELET} {LEVELS}-level {BATCH}x{N} float32 periodic",
        "seconds_per_call": t,
        "rmse": rmse,
        "measured_copy_gbps": bw,
        "copy_bound_msamples": bound,
        "pct_of_copy_bound": 100 * rate / bound,
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Full latency table vs the reference's published rows, on the GPU.

Covers every row class of BASELINE.md (reference: 24-core CPU, GraalVM —
docs/BENCHMARK-RESULTS.md:22-107) plus the BASELINE.json configs,
single-transform latency shaped like the reference's JMH benchmarks.
Prints the card's name and power limit, then one JSON object with every
row.  Needs a GPU: exits non-zero without one.  Run:
``python bench_full.py``.

Timing: on-device fori_loop chains (the carry feeds the next call); every
chained step consumes all outputs so XLA cannot dead-code-eliminate half
the transform.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)


def _measure_ms(fn, x0, iters, reps=3):
    """Returns (median, min, max) ms/iter over ``reps`` chain runs."""
    import jax

    @jax.jit
    def repeat(y):
        return jax.lax.fori_loop(0, iters, lambda _, z: fn(z), y)

    jax.block_until_ready(repeat(x0))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(repeat(x0))
        times.append(time.perf_counter() - t0)
    scale = 1e3 / iters
    return (float(np.median(times)) * scale, float(min(times)) * scale,
            float(max(times)) * scale)


def measure_all() -> dict:
    import jax
    import jax.numpy as jnp

    import vectorwave_tpu as vw
    from vectorwave_tpu.streaming import SlidingStreamingTransform, sliding_step

    device = jax.devices()[0]
    rng = np.random.default_rng(0)

    def sig(n, b=None):
        shape = (n,) if b is None else (b, n)
        return jnp.asarray(rng.standard_normal(shape), dtype=jnp.float32)

    def fwd(wavelet):
        def fn(x):
            res = vw.modwt(x, wavelet, boundary="periodic")
            return res.approx + 1e-3 * res.detail

        return fn

    def ml(wavelet, levels):
        def fn(x):
            res = vw.modwt_multilevel(x, wavelet, levels=levels)
            acc = res.approx
            for d in res.details:
                acc = acc + 1e-3 * d
            return acc

        return fn

    def rt(wavelet, levels):
        def fn(x):
            res = vw.modwt_multilevel(x, wavelet, levels=levels)
            return vw.imodwt_multilevel(res, wavelet)

        return fn

    def dn(levels):
        def fn(x):
            return vw.denoise_multilevel(
                x, "db4", levels=levels, method="universal", mode="soft"
            )

        return fn

    def cwt_fn(scales):
        sc = tuple(np.geomspace(2.0, 64.0, scales).tolist())

        def fn(x):
            res = vw.cwt(x, sc, "morl")
            return 1e-3 * res.coeffs.sum(axis=-2).real.astype(x.dtype) + x

        return fn

    def sharpe_fn(x):
        import vectorwave_tpu.finance as fin

        s = fin.wavelet_sharpe_ratio(x, wavelet="db4", levels=4)
        return x + 1e-9 * s

    # (name, fn, signal, iters, ref_core_ms, ref_ext_ms, source)
    rows = [
        ("MODWT fwd 1K haar", fwd("haar"), sig(1024), 2000, 0.047, 0.022, "BR:22"),
        ("MODWT fwd 4K db4", fwd("db4"), sig(4096), 2000, 0.358, 0.117, "BR:26"),
        ("MODWT fwd 16K db4", fwd("db4"), sig(16384), 1000, 1.624, 0.465, "BR:29"),
        ("MODWT fwd 16K db8", fwd("db8"), sig(16384), 1000, 2.156, 0.578, "BR:30"),
        ("MODWT fwd 64K haar", fwd("haar"), sig(65536), 1000, 4.892, 1.398, "BR:31"),
        ("MODWT fwd 64K db4", fwd("db4"), sig(65536), 1000, 7.264, 1.862, "BR:32"),
        ("MODWT fwd 64K db8", fwd("db8"), sig(65536), 1000, 9.648, 2.314, "BR:33"),
        ("MODWT roundtrip 16K db4", rt("db4", 1), sig(16384), 1000, 2.84,
         0.76, "README:329"),
        ("Batch 16x4K db4 fwd", fwd("db4"), sig(4096, 16), 1000, 4.264, 0.982, "BR:42"),
        ("5-level decomp 4K db4", ml("db4", 5), sig(4096), 1000, 1.79, 0.58, "BR:60"),
        ("5-level decomp 16K db4", ml("db4", 5), sig(16384), 500, 8.12, 2.32, "BR:61"),
        ("5-level decomp 64K db4", ml("db4", 5), sig(65536), 500, 36.45, 9.31, "BR:62"),
        ("Denoise 16K 5-level", dn(5), sig(16384), 500, 14.26, 3.68, "BR:98"),
        ("Denoise 64K 6-level", dn(6), sig(65536), 300, 68.42, 15.84, "BR:99"),
        ("CWT 32 scales 8K", cwt_fn(32), sig(8192), 100, 92.6, 28.4, "BR:71"),
        ("CWT 32 scales 32K", cwt_fn(32), sig(32768), 100, 486.2, 114.8, "BR:72"),
        ("Wavelet Sharpe 10K", sharpe_fn, sig(10240), 300, 8.42, 2.14, "BR:107"),
    ]

    results = []
    for name, fn, x0, iters, ref_core, ref_ext, src in rows:
        try:
            ms, ms_min, ms_max = _measure_ms(fn, x0, iters)
            results.append(
                {"name": name, "ms": ms,
                 "ms_min": ms_min, "ms_max": ms_max,
                 "ref_core_ms": ref_core,
                 "ref_ext_ms": ref_ext, "source": src}
            )
            print(f"{name}: {ms:.4f} ms (ref ext {ref_ext} ms, "
                  f"{ref_ext/ms:.1f}x)", file=sys.stderr, flush=True)
        except Exception as exc:  # noqa: BLE001
            print(f"{name}: FAILED {type(exc).__name__}: {str(exc)[:160]}",
                  file=sys.stderr, flush=True)
            results.append(
                {"name": name, "ms": None, "ref_core_ms": ref_core,
                 "ref_ext_ms": ref_ext, "source": src}
            )

    # --- BASELINE.json config rows not shaped like a reference table row ---
    def swt_denoise_cfg3(x):  # config #3: sym8 4-level SYMMETRIC + denoise
        res = vw.swt(x, "sym8", levels=4, boundary="symmetric")
        res = vw.apply_universal_threshold(res, mode="soft")
        return vw.iswt(res, "sym8", boundary="symmetric")

    def batch_cfg4(x):  # config #4: 256 x 16K batch MODWT
        res = vw.modwt_multilevel(x, "db4", levels=6)
        return vw.imodwt_multilevel(res, "db4")

    def cwt_cfg5(x):  # config #5: Morlet 64-scale on a 1M-sample signal
        sc = tuple(np.geomspace(2.0, 4096.0, 64).tolist())
        res = vw.cwt(x, sc, "morl", boundary="periodic")
        return 1e-3 * res.coeffs.sum(axis=-2).astype(x.dtype) + x

    def sym_roundtrip(x):  # symmetric boundary, both directions
        res = vw.modwt_multilevel(x, "db4", levels=6, boundary="symmetric")
        return vw.imodwt_multilevel(res, "db4", boundary="symmetric")

    # tiled (shard_map) path on a 1-device mesh: the distributed tier's
    # shard-local rate against the single-device rows
    from jax.sharding import Mesh
    from vectorwave_tpu.parallel.tiled import (
        imodwt_multilevel_tiled,
        modwt_multilevel_tiled,
    )

    mesh1 = Mesh(np.array(jax.devices()[:1]), ("signal",))

    def tiled_roundtrip_row(x):
        res = modwt_multilevel_tiled(x, "db4", levels=6, mesh=mesh1)
        return imodwt_multilevel_tiled(res, "db4", mesh=mesh1)

    baseline_rows = []
    for name, fn, x0, iters, samples in (
        ("cfg3 SWT sym8 4-level symmetric denoise 16K", swt_denoise_cfg3,
         sig(16384), 300, None),
        ("cfg4 batch 256x16K db4 6-level roundtrip", batch_cfg4,
         sig(16384, 256), 150, 256 * 16384),
        ("cfg5 CWT morl 64-scale 1M samples", cwt_cfg5, sig(1 << 20), 20,
         None),
        ("symmetric roundtrip 128x64K db4 6-level",
         sym_roundtrip, sig(65536, 128), 100, 128 * 65536),
        ("tiled 1-dev mesh roundtrip 128x64K db4 6-level",
         tiled_roundtrip_row, sig(65536, 128), 100, 128 * 65536),
    ):
        try:
            ms, ms_min, ms_max = _measure_ms(fn, x0, iters)
            row = {"name": name, "ms": ms,
                   "ms_min": ms_min, "ms_max": ms_max}
            if samples:
                row["msamples_per_s"] = samples / ms / 1e3
            baseline_rows.append(row)
            print(f"{name}: {ms:.4f} ms", file=sys.stderr, flush=True)
        except Exception as exc:  # noqa: BLE001
            print(f"{name}: FAILED {type(exc).__name__}: {str(exc)[:160]}",
                  file=sys.stderr, flush=True)
            baseline_rows.append({"name": name, "ms": None})

    # streaming per-sample latency: one sliding window step per
    # buffer_size-overlap new samples
    buffer_size, wavelet = 512, "db4"
    t = SlidingStreamingTransform(wavelet, buffer_size=buffer_size)
    from vectorwave_tpu.streaming import sliding_init

    state0 = sliding_init(buffer_size)
    block = sig(t.step)

    def stream_step(carry):
        st, blk = carry
        st, res = sliding_step(st, blk, wavelet)
        return (st, blk + 1e-6 * res.detail[..., -t.step:])

    @jax.jit
    def stream_chain(carry):
        return jax.lax.fori_loop(0, 500, lambda _, c: stream_step(c), carry)

    jax.block_until_ready(stream_chain((state0, block)))
    t0 = time.perf_counter()
    jax.block_until_ready(stream_chain((state0, block)))
    per_window = (time.perf_counter() - t0) / 500
    per_sample_us = per_window / t.step * 1e6
    print(f"streaming: {per_sample_us:.4f} us/sample", file=sys.stderr,
          flush=True)

    # host ingest: C++ SPSC ring, push + overlapping frame assembly
    ingest = _measure_ingest()
    print(f"ingest: {ingest['cpp_mticks_per_s']} Mticks/s C++ / "
          f"{ingest['numpy_mticks_per_s']} Mticks/s NumPy",
          file=sys.stderr, flush=True)

    return {
        "device": {
            "platform": device.platform,
            "kind": device.device_kind,
            "count": len(jax.devices()),
        },
        "rows": results,
        "baseline_configs": baseline_rows,
        "streaming_us_per_sample": per_sample_us,
        "streaming_buffer": buffer_size,
        "ingest": ingest,
    }


def _measure_ingest() -> dict:
    """Producer-side throughput: push + pop_frames of 512-tick windows
    (hop = 407, the sliding transform's step), single thread."""
    from vectorwave_tpu.native import RingBuffer, native_available

    frame, hop = 512, 407
    nticks = 1 << 22

    def run(backend: str) -> float:
        rb = RingBuffer(capacity=1 << 16, channels=1, backend=backend)
        chunk = np.random.default_rng(0).standard_normal(
            (4096, 1)).astype(np.float32)
        pushed = 0
        frames = 0
        t0 = time.perf_counter()
        while pushed < nticks:
            rb.push(chunk)
            pushed += len(chunk)
            while rb.available >= frame:
                got = rb.pop_frames(frame, hop, max_frames=8)
                frames += got.shape[0] if got.size else 0
                if not got.size:
                    break
        dt = time.perf_counter() - t0
        rb.close()
        return pushed / dt / 1e6

    out = {"numpy_mticks_per_s": run("python")}
    out["cpp_mticks_per_s"] = (
        run("native") if native_available() else None
    )
    out["frame"], out["hop"] = frame, hop
    return out


def main() -> int:
    import jax

    import vectorwave_tpu as vw
    from vectorwave_tpu.observability import card_description

    vw.enable_compilation_cache()
    device = jax.devices()[0]
    if device.platform != "gpu":
        print(f"bench_full: needs a GPU, found {device.platform!r}",
              file=sys.stderr)
        return 1
    card = card_description()
    print(f"card: {card}", flush=True)
    full = measure_all()
    full["card"] = card
    print(json.dumps(full))
    return 0


if __name__ == "__main__":
    sys.exit(main())

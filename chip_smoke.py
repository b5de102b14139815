"""Smoke test of the wavelet engine's main path on NVIDIA GPUs.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --multi   # four cards: the sharded paths only

One card, one process, phases in order:

1. device and card: a GPU is required (no CPU run); the card's name and power
   limit come from ``nvidia-smi`` in a child process that never imports JAX;
2. the db4 6-level periodic ``modwt_multilevel`` -> ``imodwt_multilevel``
   round trip on 128 x 65,536 float32 (BASELINE.json config #2, bench.py),
   checked against a float64 NumPy cascade that does not use this package;
3. ``denoise_multilevel(x, "db4", levels=6)`` at the same shape, checked
   against the same call in float64 on the CPU backend;
4. ``cwt`` with 64 log-spaced Morlet scales on 1,048,576 samples
   (BASELINE.json config #5), checked against a float64 NumPy FFT reference;
5. the exact tier: ``tolerance=1e-10`` round trip at 128 x 65,536 in float64,
   its coefficients checked against the float64 NumPy cascade of phase 2;
6. steady-state time per call and compile time of phases 2-5.

``--multi`` runs the 128 x 65,536 round trip tiled over a 4-card ``signal``
mesh and the sharded batch facade over a 4-card ``data`` mesh, each compared
with the one-card result of the same public call.

Every comparison prints its tolerance.  The last line of standard output is
one JSON object: ``{"ok": true, "device": {"platform", "kind", "count"}}``;
any failed check exits non-zero without it.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np

WAVELET = "db4"
LEVELS = 6
BATCH = 128
N = 1 << 16
CHECK_ROWS = 4
CWT_N = 1 << 20
CWT_SCALES = 64
REPS = 20

#: db4 (8-tap Daubechies) low-pass filter from the published high-precision
#: table (Daubechies' N=4 filter, sum sqrt(2)), in this package's order —
#: independent of the package's own generated coefficients.  Lower-precision
#: tables (PyWavelets' is off by up to 4e-13 per tap) cannot serve the
#: float64 check of phase 5.
DB4_LOW = np.array([
    0.2303778133088965008632911830440708500016152482483092977910968,
    0.7148465705529156470899219552739926037076084010993081758450110,
    0.6308807679298589078817163383006152202032229226771951174057473,
    -0.02798376941685985421141374718007538541198732022449175284003358,
    -0.1870348117190930840795706727890814195845441743745800912057770,
    0.03084138183556076362721936253495905017031482172003403341821219,
    0.03288301166688519973540751354924438866454194113754971259727278,
    -0.01059740178506903210488320852402722918109996490637641983484974,
])

TOL_COEFF = 1e-5      # phase 2: per-level coefficients, max-abs
TOL_RT_RMSE = 1e-6    # phase 2: round-trip RMSE, unit-variance input
TOL_DENOISE = 1e-5    # phase 3: max-abs vs float64 on the CPU backend
TOL_CWT_REL = 1e-5    # phase 4: max-abs / row max-abs, per checked scale
TOL_EXACT_RMSE = 1e-10  # phase 5: round-trip RMSE vs the float64 input
TOL_EXACT_COEFF = 1e-12  # phase 5: per-level coefficients, max-abs
TOL_MULTI = 1e-6      # --multi: RMS difference vs the one-card result
TOL_MULTI_MAX = 1e-5  # --multi: max-abs difference vs the one-card result


class CheckFailed(RuntimeError):
    pass


def check(name: str, value: float, limit: float) -> None:
    ok = bool(value <= limit)
    print(f"check {name}: {value:.3e} <= {limit:.0e} {'ok' if ok else 'FAILED'}",
          flush=True)
    if not ok:
        raise CheckFailed(f"{name}: {value} > {limit}")


# ---------------------------------------------------------------------------
# float64 NumPy references (no package code)
# ---------------------------------------------------------------------------


def np_filters(low: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(low, high) per-stage MODWT filters: QMF high-pass, 1/sqrt(2) scaled."""
    signs = np.where(np.arange(len(low)) % 2 == 0, 1.0, -1.0)
    high = signs * low[::-1]
    return low / math.sqrt(2.0), high / math.sqrt(2.0)


def np_modwt(x: np.ndarray, low: np.ndarray, levels: int):
    """Periodic à trous analysis: W_j[t] = sum_l g_l V_{j-1}[t - 2^(j-1) l]."""
    h, g = np_filters(low)
    cur = np.asarray(x, np.float64)
    details = []
    for j in range(1, levels + 1):
        s = 1 << (j - 1)
        approx = sum(c * np.roll(cur, s * l, axis=-1) for l, c in enumerate(h))
        details.append(sum(c * np.roll(cur, s * l, axis=-1) for l, c in enumerate(g)))
        cur = approx
    return details, cur


def np_imodwt(details, approx: np.ndarray, low: np.ndarray) -> np.ndarray:
    """Periodic synthesis: V_{j-1}[t] = sum_l h_l V_j[t + s l] + g_l W_j[t + s l]."""
    h, g = np_filters(low)
    cur = np.asarray(approx, np.float64)
    for j in range(len(details), 0, -1):
        s = 1 << (j - 1)
        d = np.asarray(details[j - 1], np.float64)
        cur = sum(c * np.roll(cur, -s * l, axis=-1) for l, c in enumerate(h)) + sum(
            c * np.roll(d, -s * l, axis=-1) for l, c in enumerate(g)
        )
    return cur


def np_morlet(t: np.ndarray, omega0: float = 6.0) -> np.ndarray:
    """Unit-energy real Morlet with the admissibility correction (closed-form
    normalization of (cos(w0 t) - e^{-w0^2/2}) e^{-t^2/2})."""
    c = math.exp(-0.5 * omega0**2)
    energy = math.sqrt(math.pi) * (
        0.5 * (1.0 + math.exp(-(omega0**2))) - 2.0 * c * math.exp(-0.25 * omega0**2) + c * c
    )
    return (np.cos(omega0 * t) - c) * np.exp(-0.5 * t * t) / math.sqrt(energy)


def np_cwt_row(x: np.ndarray, scale: float) -> np.ndarray:
    """Periodic CWT row: out[t] = sum_|k|<=4s psi(k/s)/sqrt(s) x[t + k]."""
    n = x.shape[-1]
    half = max(1, math.ceil(scale * 4.0))
    k = np.arange(-half, half + 1)
    bank = np.zeros(n)
    np.add.at(bank, k % n, np_morlet(k / scale) / math.sqrt(scale))
    spec = np.fft.rfft(np.asarray(x, np.float64)) * np.conj(np.fft.rfft(bank))
    return np.fft.irfft(spec, n)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def compile_and_time(fn, *args, reps: int = REPS):
    """(compiled, compile seconds, median steady-state seconds per call)."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(compiled(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)
    return compiled, compile_s, float(np.median(times))


def print_memory(name: str, compiled) -> None:
    mem = compiled.memory_analysis()
    if mem is None:
        print(f"memory {name}: not reported", flush=True)
        return
    fields = {k: getattr(mem, k) for k in dir(mem)
              if k.endswith("_in_bytes") and not k.startswith("_")
              and not k.startswith("host_")}
    print(f"memory {name}: {json.dumps(fields, sort_keys=True)}", flush=True)


# ---------------------------------------------------------------------------
# phases (each takes its sizes so it can be rehearsed small)
# ---------------------------------------------------------------------------


def make_signal(batch: int, n: int, seed: int = 0):
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.standard_normal((batch, n)), jnp.float32)


def phase_roundtrip(x, *, levels: int = LEVELS, check_rows: int = CHECK_ROWS,
                    reps: int = REPS) -> dict:
    import jax

    import vectorwave_tpu as vw

    def analysis(y):
        return vw.modwt_multilevel(y, WAVELET, levels=levels, boundary="periodic")

    def roundtrip(y):
        return vw.imodwt_multilevel(analysis(y), WAVELET, boundary="periodic")

    compiled, compile_s, step_s = compile_and_time(roundtrip, x, reps=reps)
    print_memory("roundtrip", compiled)
    out = np.asarray(compiled(x)[:check_rows], np.float64)
    res = jax.jit(analysis)(x)
    rows = np.asarray(x[:check_rows], np.float64)
    ref_d, ref_a = np_modwt(rows, DB4_LOW, levels)
    coeff_err = max(
        float(np.max(np.abs(np.asarray(got[:check_rows], np.float64) - want)))
        for got, want in zip(tuple(res.details) + (res.approx,), tuple(ref_d) + (ref_a,))
    )
    check("roundtrip per-level coefficients max-abs vs NumPy float64",
          coeff_err, TOL_COEFF)
    ref_out = np_imodwt(ref_d, ref_a, DB4_LOW)
    check("roundtrip NumPy reference reconstruction max-abs",
          float(np.max(np.abs(ref_out - rows))), TOL_RT_RMSE)
    rmse = float(np.sqrt(np.mean((out - rows) ** 2)))
    check("roundtrip RMSE vs input", rmse, TOL_RT_RMSE)
    return {"compile_s": compile_s, "step_s": step_s, "rmse": rmse,
            "coeff_max_abs": coeff_err}


def phase_denoise(x, *, levels: int = LEVELS, check_rows: int = CHECK_ROWS,
                  reps: int = REPS) -> dict:
    import jax
    import jax.numpy as jnp

    import vectorwave_tpu as vw

    def denoise(y):
        return vw.denoise_multilevel(y, WAVELET, levels=levels,
                                     method="universal", mode="soft")

    compiled, compile_s, step_s = compile_and_time(denoise, x, reps=reps)
    print_memory("denoise", compiled)
    out = np.asarray(compiled(x)[:check_rows], np.float64)
    rows = np.asarray(x[:check_rows], np.float64)
    with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
        ref = np.asarray(denoise(jnp.asarray(rows, jnp.float64)))
    err = float(np.max(np.abs(out - ref)))
    check("denoise max-abs vs float64 on the CPU backend", err, TOL_DENOISE)
    return {"compile_s": compile_s, "step_s": step_s, "max_abs": err}


def cwt_scales(count: int = CWT_SCALES, largest: float = 4096.0) -> tuple[float, ...]:
    import vectorwave_tpu as vw

    return vw.scales_log(2.0, largest, count)


def phase_cwt(x1, scales, *, reps: int = REPS) -> dict:
    import vectorwave_tpu as vw

    def cwt(y):
        return vw.cwt(y, scales, "morl", boundary="periodic").coeffs

    compiled, compile_s, step_s = compile_and_time(cwt, x1, reps=reps)
    print_memory("cwt", compiled)
    out = compiled(x1)
    xs = np.asarray(x1, np.float64)
    picks = sorted({0, len(scales) // 3, 2 * len(scales) // 3, len(scales) - 1})
    worst = 0.0
    for i in picks:
        ref = np_cwt_row(xs, scales[i])
        got = np.asarray(out[i], np.float64)
        rel = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
        print(f"cwt scale {scales[i]:.4g}: max-abs / row max {rel:.3e}", flush=True)
        worst = max(worst, rel)
    check(f"cwt worst of {len(picks)} scales (smallest..largest) vs NumPy "
          "float64 FFT", worst, TOL_CWT_REL)
    return {"compile_s": compile_s, "step_s": step_s, "max_rel": worst}


def phase_exact(x, *, levels: int = LEVELS, check_rows: int = CHECK_ROWS,
                reps: int = REPS) -> dict:
    import jax
    import jax.numpy as jnp

    import vectorwave_tpu as vw

    jax.config.update("jax_enable_x64", True)
    x64 = x.astype(jnp.float64)

    def analysis(y):
        return vw.modwt_multilevel(y, WAVELET, levels=levels, tolerance=1e-10)

    def exact_roundtrip(y):
        return vw.imodwt_multilevel(analysis(y), WAVELET, tolerance=1e-10)

    compiled, compile_s, step_s = compile_and_time(exact_roundtrip, x, reps=reps)
    print_memory("exact", compiled)
    out = compiled(x)
    if out.dtype != jnp.float64:
        raise CheckFailed(f"exact tier returned {out.dtype}, not float64")
    res = jax.jit(analysis)(x)
    rows = np.asarray(x[:check_rows], np.float64)
    ref_d, ref_a = np_modwt(rows, DB4_LOW, levels)
    coeff_err = max(
        float(np.max(np.abs(np.asarray(got[:check_rows]) - want)))
        for got, want in zip(tuple(res.details) + (res.approx,), tuple(ref_d) + (ref_a,))
    )
    check("exact per-level coefficients max-abs vs NumPy float64",
          coeff_err, TOL_EXACT_COEFF)
    rmse = float(jnp.sqrt(jnp.mean((out - x64) ** 2)))
    check("exact round-trip RMSE vs float64 input", rmse, TOL_EXACT_RMSE)
    return {"compile_s": compile_s, "step_s": step_s, "rmse": rmse,
            "coeff_max_abs": coeff_err}


def placement(name: str, arr) -> list:
    shards = [(str(s.device), tuple(s.data.shape)) for s in arr.addressable_shards]
    print(f"placement {name}: {shards}", flush=True)
    return shards


def compare(name: str, got, want) -> None:
    """RMS and max-abs difference of two arrays against the --multi bounds."""
    diff = np.asarray(got, np.float64) - np.asarray(want, np.float64)
    check(f"{name} RMS difference vs one card",
          float(np.sqrt(np.mean(diff**2))), TOL_MULTI)
    check(f"{name} max-abs difference vs one card",
          float(np.max(np.abs(diff))), TOL_MULTI_MAX)


def phase_multi(x, devices, *, levels: int = LEVELS) -> dict:
    """Signal-tiled round trip and sharded batch over 4 devices vs one."""
    import jax

    import vectorwave_tpu as vw
    from vectorwave_tpu.parallel import (
        imodwt_multilevel_tiled,
        make_mesh,
        modwt_multilevel_sharded_batch,
        modwt_multilevel_tiled,
    )

    one = jax.device_put(x, devices[0])
    ref_res = vw.modwt_multilevel(one, WAVELET, levels=levels)
    ref_rt = vw.imodwt_multilevel(ref_res, WAVELET)
    results = {}

    smesh = make_mesh({"signal": len(devices)}, devices=devices)
    t0 = time.perf_counter()
    tiled = modwt_multilevel_tiled(x, WAVELET, levels=levels, mesh=smesh,
                                   axis="signal")
    rt = imodwt_multilevel_tiled(tiled, WAVELET, mesh=smesh, axis="signal")
    jax.block_until_ready(rt)
    results["tiled_first_call_s"] = time.perf_counter() - t0
    shards = placement("tiled round trip", rt)
    if len({d for d, _ in shards}) != len(devices):
        raise CheckFailed("tiled output is not spread over every device")
    compare("signal-tiled round trip", rt, ref_rt)
    compare("signal-tiled level-1 detail", tiled.details[0], ref_res.details[0])

    dmesh = make_mesh({"data": len(devices)}, devices=devices)
    batch = modwt_multilevel_sharded_batch(x, WAVELET, levels=levels,
                                           mesh=dmesh, axis="data")
    shards = placement("sharded batch approx", batch.approx)
    if len({d for d, _ in shards}) != len(devices):
        raise CheckFailed("sharded batch is not spread over every device")
    for j, (a, b) in enumerate(zip(tuple(batch.details) + (batch.approx,),
                                   tuple(ref_res.details) + (ref_res.approx,))):
        compare(f"sharded batch plane {j}", a, b)
    return results


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--multi", action="store_true",
                        help="run only the 4-card sharded paths")
    args = parser.parse_args(argv)

    import jax

    import vectorwave_tpu as vw
    from vectorwave_tpu.observability import card_description

    vw.enable_compilation_cache()
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, found {devices[0].platform!r}",
              file=sys.stderr)
        return 1
    card = card_description()
    print(f"card: {card}", flush=True)
    dev = {"platform": devices[0].platform, "kind": devices[0].device_kind,
           "count": len(devices)}
    print(f"device: {json.dumps(dev)}", flush=True)

    try:
        if args.multi:
            if len(devices) < 4:
                raise CheckFailed(f"--multi needs 4 cards, found {len(devices)}")
            out = phase_multi(make_signal(BATCH, N), devices[:4])
            print(f"multi first call (compile included) "
                  f"{out['tiled_first_call_s']:.3f} s [{card}]", flush=True)
        else:
            x = make_signal(BATCH, N)
            timings = {
                "roundtrip 128x65536 db4 J=6": phase_roundtrip(x),
                "denoise 128x65536 db4 J=6": phase_denoise(x),
                "cwt morl 64 scales x 1048576": phase_cwt(
                    make_signal(1, CWT_N, seed=1)[0], cwt_scales()
                ),
                "exact roundtrip 128x65536 float64": phase_exact(x),
            }
            for name, t in timings.items():
                print(f"time {name}: {t['step_s'] * 1e3:.4f} ms/call median of "
                      f"{REPS}, compile {t['compile_s']:.3f} s [{card}]",
                      flush=True)
    except CheckFailed as exc:
        print(f"chip_smoke: FAILED {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

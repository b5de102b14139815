"""Runtime performance learning: calibration, prediction, FFT routing.

Counterpart of the reference's RuntimeLearningDemo /
PerformanceCalibrationDemo / AdaptiveThresholdTuner examples: measure the
actual device once, predict a transform's cost with a confidence interval
from that measurement, and inspect the FFT-vs-direct routing rule.
Run: python examples/calibration_demo.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax

from vectorwave_tpu import cost_model
from vectorwave_tpu.ops.facade import get_performance_info, should_use_fft
from vectorwave_tpu.wavelets.registry import wavelet


def main() -> None:
    dev = jax.devices()[0]
    print(f"device: {dev.platform} ({dev.device_kind})")
    info = get_performance_info()
    print(f"  {info.description}")
    print(f"  devices: {info.device_count}")

    # --- calibrate: measure this device, persist the sustained rate ------
    # (an uncalibrated device kind has no prediction: it raises)
    rate = cost_model.calibrate(sizes=(16384,), batch=4, persist=True)
    print(f"calibrated sustained rate: {rate / 1e6:.1f} Msamples/s")

    pred = cost_model.estimate_processing_time(65536, levels=6, batch=8)
    print(f"predicted 8x64K 6-level round-trip: "
          f"{pred.estimated_seconds * 1e3:.2f} ms "
          f"[{pred.lower_seconds * 1e3:.2f}, {pred.upper_seconds * 1e3:.2f}]")

    # --- FFT-vs-unrolled routing (the FftHeuristics counterpart) ---------
    # The unrolled à trous form serves every builtin filter; FFT engages
    # only for >=64-tap custom filters.
    print("\nFFT routing decisions (filter taps -> use FFT?):")
    for name in ("db4", "sym8", "dmey"):
        taps = len(wavelet(name).dec_lo)
        print(f"  {name:<5} ({taps:>2} taps, N=65536): "
              f"{should_use_fft(65536, taps)}")
    print(f"  custom 96-tap filter, N=65536: {should_use_fft(65536, 96)}")


if __name__ == "__main__":
    main()

"""Streaming memory behavior: bounded state, flush semantics, large signals.

Counterpart of the reference's MemoryEfficiencyMODWTDemo and
BatchStreamingFlushExample (vectorwave-examples/...): process an
arbitrarily long signal in fixed-size blocks with O(levels * filter)
carried state — and drain the tail correctly with flush().  The deeper
point is that block streaming keeps the device working set bounded
regardless of total signal length.
Run: python examples/memory_and_flush_demo.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax.numpy as jnp
import numpy as np

import vectorwave_tpu as vw
from vectorwave_tpu.streaming.stream import (
    StreamingTransform,
    history_length,
    suggest_flush_tail_length,
)

WAVELET, LEVELS = "db4", 4
BLOCK, N_BLOCKS = 1024, 64  # 65536 samples total, never held at once


def main() -> None:
    rng = np.random.default_rng(9)
    full = rng.standard_normal(BLOCK * N_BLOCKS)

    # Carried state is tiny and CONSTANT in signal length:
    l0 = len(vw.wavelet(WAVELET).dec_lo)
    hist = sum(history_length(l0, j) for j in range(1, LEVELS + 1))
    state_bytes = hist * 8
    signal_bytes = full.nbytes
    print(f"signal {signal_bytes/1e6:.1f} MB; carried history {hist} samples "
          f"({state_bytes/1e3:.1f} kB) — {signal_bytes/state_bytes:.0f}x smaller")

    stream = StreamingTransform(WAVELET, levels=LEVELS)
    outputs = [stream.process(full[i * BLOCK:(i + 1) * BLOCK])
               for i in range(N_BLOCKS)]

    # flush() drains the history tail so nothing is lost at end-of-stream.
    tail = suggest_flush_tail_length(WAVELET, LEVELS)
    flushed = stream.flush(tail)
    print(f"flush tail: {tail} samples, flushed block shape "
          f"{flushed.approx.shape}")

    # Streamed output bit-matches the whole-signal transform (streaming is
    # causal, so parity is defined against the zero-extension boundary).
    whole = vw.modwt_multilevel(
        jnp.asarray(full, dtype=jnp.float32), WAVELET, levels=LEVELS,
        boundary="zero",
    )
    streamed_a = jnp.concatenate([o.approx for o in outputs])
    err = float(jnp.max(jnp.abs(streamed_a - whole.approx)))
    print(f"streamed vs whole-signal approx, max error: {err:.2e}")

    stats = stream.statistics
    print(f"processed: {stats['samples_processed']} samples in "
          f"{stats['blocks_processed']} blocks")


if __name__ == "__main__":
    main()

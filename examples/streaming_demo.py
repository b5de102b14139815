"""Streaming transforms: block, sliding-window and denoiser streams.

Counterpart of the reference's streaming demos
(vectorwave-examples: StreamingDenoiserDemo, MODWTStreamingDemo).
Run: python examples/streaming_demo.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax.numpy as jnp
import numpy as np

import vectorwave_tpu as vw
from vectorwave_tpu.streaming import (
    SlidingStreamingTransform,
    StreamingDenoiser,
    StreamingTransform,
)


def main() -> None:
    rng = np.random.default_rng(0)
    t = np.arange(4096)
    stream = np.sin(2 * np.pi * t / 128) + 0.4 * rng.standard_normal(len(t))

    # --- block streaming: bit-identical to the whole-signal transform ------
    xform = StreamingTransform("db4", levels=3, boundary="zero")
    block_results = [xform.process(stream[i : i + 512]) for i in range(0, 4096, 512)]
    streamed_d1 = jnp.concatenate([r.details[0] for r in block_results], axis=-1)
    whole = vw.modwt_multilevel(
        jnp.asarray(stream, jnp.float32), "db4", levels=3, boundary="zero"
    )
    dev = float(jnp.max(jnp.abs(streamed_d1 - whole.details[0])))
    print(f"block streaming vs whole-signal (level-1 detail): {dev:.2e}")
    print(f"  statistics: {xform.statistics}")

    # --- sliding window with per-sample feeding ----------------------------
    sliding = SlidingStreamingTransform("db4", buffer_size=256)
    emitted = 0
    for sample in stream[:1500]:
        if sliding.process_sample(float(sample)) is not None:
            emitted += 1
    print(
        f"sliding window: {emitted} windows over 1500 samples "
        f"(overlap {sliding.overlap}, step {sliding.step})"
    )

    # --- streaming denoiser (MAD noise tracking, ring window) --------------
    den = StreamingDenoiser("sym8", implementation="quality", levels=4)
    cleaned = jnp.concatenate(
        [den.denoise(stream[i : i + 512]) for i in range(0, 4096, 512)], axis=-1
    )
    clean_ref = np.sin(2 * np.pi * t / 128)
    before = float(np.sqrt(np.mean((stream - clean_ref) ** 2)))
    after = float(np.sqrt(np.mean((np.asarray(cleaned) - clean_ref) ** 2)))
    print(f"streaming denoise RMSE: {before:.3f} -> {after:.3f}")

    # --- the same denoiser as a pure step function (jit/scan-friendly) ----
    from vectorwave_tpu.streaming import (
        streaming_denoise_block,
        streaming_denoiser_init,
    )

    st = streaming_denoiser_init("sym8", levels=4)
    outs = []
    for i in range(0, 4096, 512):
        st, blk = streaming_denoise_block(
            st, jnp.asarray(stream[i : i + 512], jnp.float32), "sym8"
        )
        outs.append(np.asarray(blk))
    functional = np.concatenate(outs, axis=-1)
    after_f = float(np.sqrt(np.mean((functional - clean_ref) ** 2)))
    print(f"functional streaming denoise RMSE: {before:.3f} -> {after_f:.3f}")


if __name__ == "__main__":
    main()

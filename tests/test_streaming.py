"""Streaming MODWT + streaming denoiser.

Mirrors the reference's streaming tests: block-vs-whole-signal bit parity via
the left-history contract (BatchStreamingMODWT), flush semantics, and the
streaming denoiser's noise tracking.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import vectorwave_tpu as vw
from vectorwave_tpu.streaming import (
    StreamingDenoiser,
    modwt_stream_block,
    modwt_stream_flush,
    streaming_denoiser_init,
    streaming_denoise_block,
    streaming_init,
    suggest_flush_tail_length,
)
from .conftest import composite_sin


@pytest.mark.parametrize("block_size", [64, 100, 256])
@pytest.mark.parametrize("name,levels", [("haar", 3), ("db4", 3), ("sym8", 2)])
def test_streaming_matches_whole_signal_zero_boundary(name, levels, block_size):
    """Concatenated block outputs == whole-signal ZERO_PADDING transform,
    bit-parity (the reference's history-kernel equivalence tests)."""
    n = 512
    x = composite_sin(n, noise_std=0.3)
    whole = vw.modwt_multilevel(jnp.asarray(x), name, levels=levels, boundary="zero")

    state = streaming_init(name, levels, dtype=jnp.float64)
    outs = []
    for start in range(0, n, block_size):
        state, res = modwt_stream_block(
            state, jnp.asarray(x[start : start + block_size]), name, boundary="zero"
        )
        outs.append(res)
    for j in range(levels):
        streamed = np.concatenate([np.asarray(o.details[j]) for o in outs], axis=-1)
        np.testing.assert_allclose(streamed, np.asarray(whole.details[j]), atol=1e-12)
    streamed_approx = np.concatenate([np.asarray(o.approx) for o in outs], axis=-1)
    np.testing.assert_allclose(streamed_approx, np.asarray(whole.approx), atol=1e-12)


def test_streaming_symmetric_matches_whole_signal_interior():
    n = 512
    levels = 3
    x = composite_sin(n, noise_std=0.2)
    whole = vw.modwt_multilevel(jnp.asarray(x), "db4", levels=levels, boundary="symmetric")
    state = streaming_init("db4", levels, dtype=jnp.float64)
    outs = []
    for start in range(0, n, 128):
        state, res = modwt_stream_block(
            state, jnp.asarray(x[start : start + 128]), "db4", boundary="symmetric"
        )
        outs.append(res)
    streamed = np.concatenate([np.asarray(o.details[0]) for o in outs], axis=-1)
    # identical except where whole-signal wraps the RIGHT edge (streaming only
    # extends left): compare everything (left edge included — first-block
    # mirror gives parity there)
    np.testing.assert_allclose(streamed, np.asarray(whole.details[0]), atol=1e-12)


def test_streaming_periodic_is_per_block():
    x = composite_sin(256)
    state = streaming_init("db4", 2, dtype=jnp.float64)
    state, res = modwt_stream_block(state, jnp.asarray(x[:128]), "db4", boundary="periodic")
    expected = vw.modwt_multilevel(jnp.asarray(x[:128]), "db4", levels=2, boundary="periodic")
    np.testing.assert_allclose(np.asarray(res.details[0]), np.asarray(expected.details[0]), atol=1e-12)


def test_flush_drains_history():
    levels = 2
    tail = suggest_flush_tail_length("db4", levels)
    assert tail == 7 * 2  # (8-1)*2^(2-1)
    state = streaming_init("db4", levels, dtype=jnp.float64)
    state, _ = modwt_stream_block(state, jnp.asarray(composite_sin(128)), "db4")
    state2, res = modwt_stream_flush(state, "db4")
    assert res.approx.shape[-1] == tail
    # flushed history equals transform of zeros-with-history: nonzero output
    assert float(jnp.abs(res.approx).max()) > 0


def test_streaming_under_scan():
    """The transition is scan-compatible: whole stream in one device loop."""
    n, block, levels = 512, 64, 2
    x = composite_sin(n, noise_std=0.1)
    blocks = jnp.asarray(x.reshape(n // block, block))
    state = streaming_init("db4", levels, dtype=jnp.float64)

    def step(carry, blk):
        new_state, res = modwt_stream_block(carry, blk, "db4", boundary="zero")
        return new_state, (res.details[0], res.approx)

    _, (details, approx) = jax.lax.scan(step, state, blocks)
    whole = vw.modwt_multilevel(jnp.asarray(x), "db4", levels=levels, boundary="zero")
    np.testing.assert_allclose(
        details.reshape(-1), np.asarray(whole.details[0]), atol=1e-12
    )


def test_streaming_batched():
    batch = np.stack([composite_sin(256, seed=s, noise_std=0.1) for s in range(3)])
    state = streaming_init("db4", 2, batch_shape=(3,), dtype=jnp.float64)
    state, res = modwt_stream_block(state, jnp.asarray(batch[:, :128]), "db4")
    assert res.approx.shape == (3, 128)


def test_streaming_denoiser_reduces_noise():
    rng = np.random.default_rng(0)
    n = 2048
    clean = composite_sin(n)
    noisy = clean + rng.normal(0, 1.0, n)
    denoiser = StreamingDenoiser("db4", implementation="quality", dtype=jnp.float64)
    outs = []
    for start in range(0, n, 256):
        outs.append(np.asarray(denoiser.denoise(noisy[start : start + 256])))
    den = np.concatenate(outs)
    # skip warm-up blocks where the noise window is still filling
    sl = slice(512, n)
    assert np.mean((den[sl] - clean[sl]) ** 2) < np.mean((noisy[sl] - clean[sl]) ** 2)
    assert denoiser.statistics["samples_processed"] == n
    assert denoiser.statistics["blocks_processed"] == 8
    denoiser.reset()
    assert denoiser.statistics["blocks_processed"] == 0


def test_streaming_denoiser_fixed_sigma():
    state = streaming_denoiser_init("haar", levels=1, dtype=jnp.float64)
    x = jnp.asarray(composite_sin(128, noise_std=0.5))
    state, out = streaming_denoise_block(
        state, x, "haar", noise_estimation="fixed", fixed_sigma=0.5
    )
    assert out.shape == x.shape
    with pytest.raises(vw.InvalidArgumentError):
        streaming_denoise_block(state, x, "haar", noise_estimation="fixed")
    with pytest.raises(vw.InvalidArgumentError):
        streaming_denoise_block(state, x, "haar", noise_estimation="bogus")


def test_streaming_transform_class():
    """Reference-like stateful wrapper (MODWTStreamingTransform ergonomics)."""
    from vectorwave_tpu.streaming import StreamingTransform

    n = 512
    x = composite_sin(n, noise_std=0.2)
    st = StreamingTransform("db4", levels=3, dtype=jnp.float64)
    outs = [st.process(x[i : i + 128]) for i in range(0, n, 128)]
    whole = vw.modwt_multilevel(jnp.asarray(x), "db4", levels=3, boundary="zero")
    streamed = np.concatenate([np.asarray(o.details[0]) for o in outs], axis=-1)
    np.testing.assert_allclose(streamed, np.asarray(whole.details[0]), atol=1e-12)
    assert st.statistics == {"samples_processed": 512, "blocks_processed": 4}
    tail = st.flush()
    assert tail.approx.shape[-1] > 0
    st.reset()
    assert st.statistics["blocks_processed"] == 0


def test_streaming_denoiser_state_restore_validates_backend():
    """A state of another layout must not silently restore onto the
    denoiser: the .state setter validates the pytree type and names the
    fix."""
    from vectorwave_tpu.streaming import StreamingDenoiser

    d = StreamingDenoiser("db4", backend="jnp")
    assert d.backend == "jnp"
    good = d.state
    transform_state = streaming_init(d.wavelet, d.levels)
    with pytest.raises(vw.InvalidArgumentError, match="resolved backend"):
        d.state = transform_state
    d.state = good  # same-layout restore still works
    d.denoise(np.zeros(256, np.float32))

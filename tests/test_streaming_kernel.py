"""Block streaming in float32 over batched rows and production-like block
sizes (streaming/stream.modwt_stream_block).

Parity oracle: the whole-signal transform (zero/symmetric) — the
left-history contract (reference: BatchStreamingMODWT.java:19-458).
f32 tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import vectorwave_tpu as vw
from vectorwave_tpu.streaming import (
    StreamingTransform,
    modwt_stream_block,
    streaming_init,
)


def _stream(x, name, levels, boundary, block_size, batch_shape=()):
    state = streaming_init(name, levels, batch_shape=batch_shape)
    outs = []
    n = x.shape[-1]
    for start in range(0, n, block_size):
        state, res = modwt_stream_block(
            state, x[..., start : start + block_size], name, boundary=boundary,
        )
        outs.append(res)
    details = tuple(
        jnp.concatenate([o.details[j] for o in outs], axis=-1)
        for j in range(levels)
    )
    approx = jnp.concatenate([o.approx for o in outs], axis=-1)
    return details, approx


@pytest.mark.parametrize("block_size", [512, 1024])
@pytest.mark.parametrize("name,levels", [("haar", 3), ("db4", 3), ("sym8", 2)])
def test_kernel_streaming_matches_whole_signal_zero(name, levels, block_size):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((2, 4096)), jnp.float32)
    whole = vw.modwt_multilevel(x, name, levels=levels, boundary="zero",
                                backend="jnp")
    details, approx = _stream(x, name, levels, "zero", block_size,
                              batch_shape=(2,))
    for j in range(levels):
        np.testing.assert_allclose(
            np.asarray(details[j]), np.asarray(whole.details[j]), atol=2e-5
        )
    np.testing.assert_allclose(
        np.asarray(approx), np.asarray(whole.approx), atol=2e-5
    )


def test_kernel_streaming_matches_whole_signal_symmetric():
    """The first block mirrors its head into the history; later blocks
    read the carried tails."""
    rng = np.random.default_rng(1)
    levels, name = 3, "db4"
    x = jnp.asarray(rng.standard_normal(4096), jnp.float32)
    whole = vw.modwt_multilevel(x, name, levels=levels, boundary="symmetric",
                                backend="jnp")
    details, approx = _stream(x, name, levels, "symmetric", 1024)
    for j in range(levels):
        np.testing.assert_allclose(
            np.asarray(details[j]), np.asarray(whole.details[j]), atol=2e-5
        )
    np.testing.assert_allclose(
        np.asarray(approx), np.asarray(whole.approx), atol=2e-5
    )


def test_kernel_streaming_unknown_boundary_raises():
    state = streaming_init("db4", 2)
    with pytest.raises(vw.InvalidArgumentError, match="Unsupported"):
        modwt_stream_block(
            state, jnp.zeros(64, jnp.float32), "db4", boundary="reflect",
        )


def test_kernel_streaming_periodic_is_per_block():
    """Periodic treats each block circularly (stateless)."""
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((1, 1024)), jnp.float32)
    state = streaming_init("db4", 2, batch_shape=(1,))
    _, res = modwt_stream_block(state, x, "db4", boundary="periodic")
    whole = vw.modwt_multilevel(x, "db4", levels=2, boundary="periodic",
                                backend="jnp")
    np.testing.assert_allclose(
        np.asarray(res.approx), np.asarray(whole.approx), atol=2e-5
    )


def test_kernel_streaming_scan_compatible():
    """The step must run under lax.scan (the on-device benchmark shape)."""
    rng = np.random.default_rng(3)
    levels = 3
    blocks = jnp.asarray(
        rng.standard_normal((4, 2, 1024)), jnp.float32
    )  # [n_blocks, B, block]
    state = streaming_init("db4", levels, batch_shape=(2,))

    def step(st, blk):
        st, res = modwt_stream_block(st, blk, "db4", boundary="zero")
        return st, res.approx

    _, approxes = jax.lax.scan(step, state, blocks)
    whole = vw.modwt_multilevel(
        blocks.transpose(1, 0, 2).reshape(2, -1), "db4", levels=levels,
        boundary="zero", backend="jnp",
    )
    got = approxes.transpose(1, 0, 2).reshape(2, -1)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(whole.approx), atol=2e-5
    )


def test_streaming_transform_kernel_backend_facade():
    """StreamingTransform rejects the removed 'pallas' backend; its default
    path matches the whole-signal transform."""
    with pytest.raises(vw.InvalidArgumentError):
        StreamingTransform("db4", levels=2, boundary="zero", backend="pallas")
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.standard_normal(2048), jnp.float32)
    st = StreamingTransform("db4", levels=2, boundary="zero", backend="jnp")
    outs = [st.process(x[s : s + 512]) for s in range(0, 2048, 512)]
    whole = vw.modwt_multilevel(x, "db4", levels=2, boundary="zero",
                                backend="jnp")
    approx = jnp.concatenate([o.approx for o in outs], axis=-1)
    np.testing.assert_allclose(
        np.asarray(approx), np.asarray(whole.approx), atol=2e-5
    )
    assert st.statistics["blocks_processed"] == 4

"""Streaming denoiser against a float64 NumPy oracle.

Contract (MODWTStreamingDenoiser.java:36-504): each block's analysis is the
whole-stream zero-boundary cascade; every 16th-stratified |d1| sample of the
block shifts into a noise window of W samples; sigma is MAD(window)/0.6745
(or STD, or fixed); level j is shrunk at ``sigma * sqrt(2 ln W) / sqrt(2^j)``
and the block is rebuilt with a block-local zero-boundary inverse.  The
oracle runs that contract on ``tests/golden.py``'s loops, independent of the
package's convolution code; the float32 stream must agree to f32 rounding.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from vectorwave_tpu.streaming import (
    StreamingDenoiser,
    streaming_denoise_block,
    streaming_denoiser_init,
)
from vectorwave_tpu.transforms.modwt import _resolve_discrete

from .golden import imodwt_multilevel_golden, modwt_multilevel_golden


def _shrink(d, t, mode):
    if mode == "soft":
        return np.sign(d) * np.maximum(np.abs(d) - t, 0.0)
    return np.where(np.abs(d) > t, d, 0.0)


def _oracle(blocks, name, levels, mode="soft", est="mad", fixed_sigma=None,
            w_size=256):
    """Per-block denoised output and final noise window of one row."""
    w = _resolve_discrete(name)
    x = np.concatenate([np.asarray(b, np.float64) for b in blocks])
    details, approx = modwt_multilevel_golden(x, w, levels, "zero")
    window = np.zeros(w_size)
    outs = []
    start = 0
    for blk in blocks:
        n = blk.shape[-1]
        d = [dj[start:start + n] for dj in details]
        take = min(16, n, w_size)
        stride = max(1, n // take)
        window = np.concatenate(
            [window[take:], np.abs(d[0][: take * stride : stride])]
        )
        if est == "mad":
            sigma = np.median(window) / 0.6745
        elif est == "std":
            sigma = np.std(window)
        else:
            sigma = fixed_sigma
        t = sigma * math.sqrt(2.0 * math.log(w_size))
        shrunk = [
            _shrink(dj, t / math.sqrt(2.0**j), mode)
            for j, dj in enumerate(d, start=1)
        ]
        outs.append(imodwt_multilevel_golden(
            shrunk, approx[start:start + n], w, "zero"
        ))
        start += n
    return outs, window


def _check_rows(blocks, outs, st, name, levels, atol, **kw):
    """Every batch row of the streamed outputs against the oracle."""
    rows = np.asarray(blocks[0]).reshape(-1, blocks[0].shape[-1]).shape[0]
    got = [np.asarray(o).reshape(rows, -1) for o in outs]
    window = np.asarray(st.noise_window).reshape(rows, -1)
    for r in range(rows):
        row_blocks = [np.asarray(b).reshape(rows, -1)[r] for b in blocks]
        want, want_window = _oracle(row_blocks, name, levels, **kw)
        for g, o in zip(got, want):
            np.testing.assert_allclose(g[r], o, atol=atol)
        np.testing.assert_allclose(window[r], want_window, atol=1e-5)


def _run(name, levels, blocks, **kw):
    batch = blocks[0].shape[:-1]
    st = streaming_denoiser_init(name, levels=levels, batch_shape=batch)
    outs = []
    for blk in blocks:
        st, out = streaming_denoise_block(st, blk, name, boundary="zero", **kw)
        outs.append(out)
    return st, outs


@pytest.mark.parametrize(
    "batch,nblk,levels,mode",
    [
        ((3,), 2048, 4, "soft"),
        ((), 1024, 3, "hard"),
        ((2,), 512, 2, "soft"),
    ],
)
def test_kernel_streaming_denoiser_matches_jnp(batch, nblk, levels, mode):
    rng = np.random.default_rng(0)
    blocks = [
        jnp.asarray(rng.standard_normal(batch + (nblk,)), jnp.float32)
        for _ in range(3)
    ]
    st, outs = _run("db4", levels, blocks, threshold_mode=mode)
    _check_rows(blocks, outs, st, "db4", levels, 5e-5, mode=mode)


def test_kernel_streaming_denoiser_fallback_shape():
    """A block that is not a multiple of 128 samples."""
    rng = np.random.default_rng(1)
    blocks = [
        jnp.asarray(rng.standard_normal(200), jnp.float32) for _ in range(2)
    ]
    st, outs = _run("db4", 2, blocks)
    _check_rows(blocks, outs, st, "db4", 2, 5e-5)


@pytest.mark.parametrize("est,kw", [("std", {}), ("fixed", {"fixed_sigma": 0.5})])
def test_kernel_streaming_denoiser_estimators(est, kw):
    rng = np.random.default_rng(2)
    blocks = [jnp.asarray(rng.standard_normal((2, 1024)), jnp.float32)]
    st, outs = _run("sym4", 3, blocks, noise_estimation=est, **kw)
    _check_rows(blocks, outs, st, "sym4", 3, 5e-5, est=est,
                fixed_sigma=kw.get("fixed_sigma"))


def test_streaming_denoiser_class_kernel_backend():
    """The removed 'pallas' backend is rejected; the class denoises on its
    one path, and reset keeps the state layout."""
    from vectorwave_tpu import InvalidArgumentError
    from vectorwave_tpu.streaming import StreamingDenoiserState

    with pytest.raises(InvalidArgumentError):
        StreamingDenoiser("db4", implementation="quality", backend="pallas")
    rng = np.random.default_rng(3)
    n, blk = 2048, 512
    clean = np.sin(np.linspace(0, 16 * np.pi, n))
    noisy = (clean + 0.4 * rng.standard_normal(n)).astype(np.float32)
    den = StreamingDenoiser("db4", implementation="quality")
    assert isinstance(den.state, StreamingDenoiserState)
    outs = [
        np.asarray(den.denoise(noisy[s : s + blk]))
        for s in range(0, n, blk)
    ]
    out = np.concatenate(outs)
    assert out.shape == (n,)
    # steady-state blocks: denoised closer to clean than noisy input
    err_out = np.mean((out[blk:] - clean[blk:]) ** 2)
    err_in = np.mean((noisy[blk:] - clean[blk:]) ** 2)
    assert err_out < err_in
    assert den.statistics["blocks_processed"] == n // blk
    den.reset()
    assert isinstance(den.state, StreamingDenoiserState)
    assert den.statistics["samples_processed"] == 0


@pytest.mark.slow
@pytest.mark.parametrize(
    "name,levels,nblk",
    [("sym8", 5, 4096), ("coif3", 3, 1536), ("db2", 6, 8192)],
)
def test_kernel_streaming_denoiser_family_sweep(name, levels, nblk):
    """Property sweep: ring-state and output parity across families,
    block sizes and depths (4 sequential blocks)."""
    rng = np.random.default_rng(7)
    blocks = [
        jnp.asarray(rng.standard_normal((2, nblk)), jnp.float32)
        for _ in range(4)
    ]
    st, outs = _run(name, levels, blocks)
    _check_rows(blocks, outs, st, name, levels, 1e-4)


def test_kernel_streaming_denoiser_scan_compatible():
    """The step function threads through lax.scan (the serving pattern:
    one compiled program over all blocks) with results identical to the
    Python loop."""
    import jax

    rng = np.random.default_rng(11)
    blocks = jnp.asarray(rng.standard_normal((4, 2, 1024)), jnp.float32)
    st0 = streaming_denoiser_init("db4", levels=3, batch_shape=(2,))

    def step(st, blk):
        st, out = streaming_denoise_block(st, blk, "db4", boundary="zero")
        return st, out

    st_scan, outs_scan = jax.lax.scan(step, st0, blocks)

    st = st0
    outs = []
    for i in range(blocks.shape[0]):
        st, o = step(st, blocks[i])
        outs.append(o)
    np.testing.assert_allclose(
        np.asarray(outs_scan), np.asarray(jnp.stack(outs)), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(st_scan.noise_window), np.asarray(st.noise_window),
        atol=1e-6,
    )

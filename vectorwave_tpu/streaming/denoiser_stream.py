"""Streaming wavelet denoiser with running noise estimation.

Re-design of ``MODWTStreamingDenoiser``
(``/root/reference/vectorwave-core/.../modwt/streaming/MODWTStreamingDenoiser.java:36-504``)
and the streaming facade (``streaming/StreamingDenoiserFactory.java:21-120``
FAST/QUALITY implementations): the builder + Flow.Publisher becomes an
explicit state pytree and a pure per-block update, plus a small convenience
class for tick-by-tick ergonomics.

Noise tracking mirrors the reference: detail coefficients of each block are
stratified-sampled into a fixed ring window; sigma = MAD(window)/0.6745 (or
STD / FIXED); the block is then denoised with threshold
``sigma * sqrt(2 ln W) * multiplier`` and reconstructed.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax.numpy as jnp

from ..errors import ErrorCode, InvalidArgumentError
from ..ops.thresholds import apply_threshold
from ..transforms.modwt import _resolve_discrete
from ..transforms.multilevel import MultiLevelMODWTResult
from .stream import StreamingState, modwt_stream_block, streaming_init

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


class StreamingDenoiserState(NamedTuple):
    transform: StreamingState
    noise_window: jnp.ndarray  # [W] ring of sampled |detail| values
    window_pos: jnp.ndarray  # scalar int32
    window_fill: jnp.ndarray  # scalar int32


def streaming_denoiser_init(
    wavelet,
    *,
    levels: int = 1,
    noise_window_size: int = 256,
    batch_shape: tuple[int, ...] = (),
    dtype=jnp.float32,
) -> StreamingDenoiserState:
    return StreamingDenoiserState(
        transform=streaming_init(wavelet, levels, batch_shape=batch_shape, dtype=dtype),
        noise_window=jnp.zeros(batch_shape + (noise_window_size,), dtype=dtype),
        window_pos=jnp.zeros((), dtype=jnp.int32),
        window_fill=jnp.zeros((), dtype=jnp.int32),
    )


def _update_noise_window(
    window: jnp.ndarray, pos, fill, detail: jnp.ndarray, samples: int = 16
):
    """Stratified-sample |detail| into the noise window
    (``updateNoiseEstimation`` :103-199): every (B/samples)-th coefficient.

    The window is a SHIFT REGISTER (newest samples at the end), not a
    cursor ring: dropping the oldest ``take`` and appending is two STATIC
    slices instead of a dynamic scatter, with the same multiset of retained
    samples, so sigma (median/std over the window) is unchanged.  ``pos``
    stays as the reference's cursor statistic.
    """
    n = detail.shape[-1]
    w = window.shape[-1]
    take = min(samples, n, w)
    stride = max(1, n // take)
    picks = jnp.abs(detail[..., : take * stride : stride])
    window = jnp.concatenate([window[..., take:], picks], axis=-1)
    return window, (pos + take) % w, jnp.minimum(fill + take, w)


def streaming_denoise_block(
    state: StreamingDenoiserState,
    block: jnp.ndarray,
    wavelet,
    *,
    boundary: str = "zero",
    threshold_mode: str = "soft",
    noise_estimation: str = "mad",
    threshold_multiplier: float = 1.0,
    fixed_sigma: float | None = None,
) -> tuple[StreamingDenoiserState, jnp.ndarray]:
    """Denoise one block; returns (new_state, denoised_block)."""
    w = _resolve_discrete(wavelet)
    levels = len(state.transform.histories)
    new_transform, coeffs = modwt_stream_block(
        state.transform, block, w, boundary=boundary
    )
    window, pos, fill = _update_noise_window(
        state.noise_window, state.window_pos, state.window_fill, coeffs.details[0]
    )
    est = noise_estimation.lower()
    if est == "mad":
        # median over the filled prefix approximated by the full ring (zeros
        # from the unfilled tail bias early estimates low, like a warm-up)
        sigma = jnp.median(window, axis=-1, keepdims=True) / 0.6745
    elif est == "std":
        sigma = jnp.std(window, axis=-1, keepdims=True)
    elif est == "fixed":
        if fixed_sigma is None:
            raise InvalidArgumentError(
                ErrorCode.CFG_INVALID_CONFIG,
                "noise_estimation='fixed' requires fixed_sigma",
            )
        sigma = jnp.asarray(fixed_sigma, dtype=block.dtype)
    else:
        raise InvalidArgumentError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"Unknown noise estimation: {noise_estimation!r}",
            suggestions=("Use 'mad', 'std' or 'fixed'",),
        )
    w_size = state.noise_window.shape[-1]
    threshold = sigma * math.sqrt(2.0 * math.log(w_size)) * threshold_multiplier
    denoised_details = tuple(
        apply_threshold(d, threshold / jnp.sqrt(2.0**level), threshold_mode)
        for level, d in enumerate(coeffs.details, start=1)
    )
    denoised = _reconstruct_block(
        MultiLevelMODWTResult(denoised_details, coeffs.approx), w
    )
    new_state = StreamingDenoiserState(new_transform, window, pos, fill)
    return new_state, denoised


def _reconstruct_block(coeffs: MultiLevelMODWTResult, w) -> jnp.ndarray:
    """Per-block inverse (zero boundary — block-local reconstruction)."""
    from ..transforms.multilevel import imodwt_multilevel

    return imodwt_multilevel(coeffs, w, boundary="zero")


class StreamingDenoiser:
    """Convenience wrapper with reference-like ergonomics
    (``MODWTStreamingDenoiser.Builder`` :370-504): holds the state pytree and
    exposes ``denoise(samples)``; FAST = 1 level, QUALITY = multi-level
    (``StreamingDenoiserFactory.Implementation``)."""

    def __init__(
        self,
        wavelet="db4",
        *,
        implementation: str = "fast",
        levels: int | None = None,
        boundary: str = "zero",
        noise_window_size: int = 256,
        threshold_mode: str = "soft",
        noise_estimation: str = "mad",
        threshold_multiplier: float = 1.0,
        dtype=jnp.float32,
        backend: str | None = None,
    ) -> None:
        if levels is None:
            levels = 1 if implementation.lower() == "fast" else 4
        self.wavelet = _resolve_discrete(wavelet)
        self.boundary = boundary
        self.threshold_mode = threshold_mode
        self.noise_estimation = noise_estimation
        self.threshold_multiplier = threshold_multiplier
        self.levels = levels
        self._dtype = dtype
        self._window_size = noise_window_size
        from ..transforms.multilevel import _check_backend

        _check_backend(backend)
        #: the resolved backend, recorded beside checkpoints
        self.backend = "jnp"
        self.samples_processed = 0
        self.blocks_processed = 0

        import jax

        self.state = streaming_denoiser_init(
            self.wavelet, levels=levels,
            noise_window_size=noise_window_size, dtype=dtype,
        )

        def _step(state, block):
            return streaming_denoise_block(
                state,
                block,
                self.wavelet,
                boundary=self.boundary,
                threshold_mode=self.threshold_mode,
                noise_estimation=self.noise_estimation,
                threshold_multiplier=self.threshold_multiplier,
            )

        # jit the whole per-block update: one fused device step per block
        # (compiled once per distinct block shape)
        self._step = jax.jit(_step)

    @property
    def state(self):
        """The streaming state pytree (checkpoint/restore surface)."""
        return self._state

    @state.setter
    def state(self, value):
        if not isinstance(value, StreamingDenoiserState):
            raise InvalidArgumentError(
                ErrorCode.CFG_INVALID_CONFIG,
                f"State layout {type(value).__name__} does not match this "
                f"denoiser's resolved backend {self.backend!r} (expected "
                "StreamingDenoiserState).",
                suggestions=("Re-init and replay the stream",),
            )
        self._state = value

    def denoise(self, samples) -> jnp.ndarray:
        self.state, out = self._step(
            self.state, jnp.asarray(samples, dtype=self._dtype)
        )
        self.samples_processed += int(out.shape[-1])
        self.blocks_processed += 1
        return out

    def reset(self) -> None:
        self.state = streaming_denoiser_init(
            self.wavelet,
            levels=self.levels,
            noise_window_size=self._window_size,
            dtype=self._dtype,
        )
        self.samples_processed = 0
        self.blocks_processed = 0

    @property
    def statistics(self) -> dict:
        """Samples/blocks counters (MODWTStreamingTransformImpl LongAdder stats)."""
        return {
            "samples_processed": self.samples_processed,
            "blocks_processed": self.blocks_processed,
        }

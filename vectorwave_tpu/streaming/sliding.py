"""Overlapping sliding-window streaming MODWT.

Re-design of the reference's single-level streaming transform
(``/root/reference/vectorwave-core/.../modwt/streaming/MODWTStreamingTransformImpl.java:45-120``
and ``MultiLevelMODWTStreamingTransform.java:169-203`` ``processSample``):

* a circular buffer of ``buffer_size`` samples keeps an overlap of
  ``filter_length - 1`` (single-level) or ``(L0-1)*(2^J - 1)`` (multi-level)
  samples in place between transforms;
* each transform consumes ``buffer_size - overlap`` NEW samples and emits
  coefficients for the full window, so consecutive windows share the overlap
  and interior coefficients are continuous;
* ``process_sample`` feeds one sample at a time, emitting a window result
  whenever the buffer fills (the reference's per-sample accumulation).

The Flow.Publisher machinery becomes a pure transition function
``state, new_samples -> state, window_coefficients`` (a ``lax.scan``-ready
carry), plus a thin stateful wrapper with reference-like ergonomics.  The
reference's 100 MB buffer cap (``MODWTStreamingTransform.java:154``) is kept
as a validation guard.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..errors import ErrorCode, InvalidArgumentError
from ..transforms.modwt import MODWTResult, _resolve_discrete, modwt
from ..transforms.multilevel import MultiLevelMODWTResult, modwt_multilevel


def total_halo(filter_length: int, levels: int) -> int:
    """Cumulative cascade halo: sum_j (L0-1) 2^(j-1) = (L0-1)(2^J - 1)."""
    return (filter_length - 1) * ((1 << levels) - 1)

#: reference cap: MAX_BUFFER_SIZE bounded so the window stays under 100 MB
_MAX_BUFFER_BYTES = 100 * 1024 * 1024


class SlidingWindowState(NamedTuple):
    """Carry: the current window contents plus fill accounting."""

    window: jnp.ndarray  # [..., buffer_size]
    samples_seen: jnp.ndarray  # scalar int32 (total pushed, for readiness)


def sliding_init(
    buffer_size: int,
    *,
    batch_shape: tuple[int, ...] = (),
    dtype=jnp.float32,
) -> SlidingWindowState:
    if buffer_size < 2:
        raise InvalidArgumentError(
            ErrorCode.VAL_TOO_SHORT,
            f"buffer_size must be >= 2, got {buffer_size}",
        )
    nbytes = buffer_size * jnp.dtype(dtype).itemsize
    for dim in batch_shape:
        nbytes *= dim
    if nbytes > _MAX_BUFFER_BYTES:
        raise InvalidArgumentError(
            ErrorCode.VAL_TOO_LARGE,
            f"Sliding window of {nbytes} bytes exceeds the 100 MB cap",
            suggestions=("Reduce buffer_size or batch size",),
        )
    return SlidingWindowState(
        jnp.zeros(batch_shape + (buffer_size,), dtype=dtype),
        jnp.zeros((), dtype=jnp.int32),
    )


def sliding_push(
    state: SlidingWindowState, new_samples: jnp.ndarray
) -> SlidingWindowState:
    """Shift ``k`` new samples into the window (oldest fall off the left)."""
    k = new_samples.shape[-1]
    buffer_size = state.window.shape[-1]
    if k > buffer_size:
        new_samples = new_samples[..., -buffer_size:]
        k = buffer_size
    window = jnp.concatenate([state.window[..., k:], new_samples], axis=-1)
    return SlidingWindowState(window, state.samples_seen + k)


def sliding_step(
    state: SlidingWindowState,
    new_samples: jnp.ndarray,
    wavelet,
    *,
    boundary: str = "periodic",
) -> tuple[SlidingWindowState, MODWTResult]:
    """Push ``buffer_size - overlap`` new samples and transform the window.

    The single-level analogue of the reference's buffer-full trigger: with
    ``new_samples`` of length ``step_size(...)``, consecutive calls reproduce
    its consume/overlap cycle exactly; the emitted coefficients cover the
    whole window (size ``buffer_size``), including the overlap region.
    """
    state = sliding_push(state, new_samples)
    return state, modwt(state.window, wavelet, boundary=boundary)


def sliding_step_multilevel(
    state: SlidingWindowState,
    new_samples: jnp.ndarray,
    wavelet,
    *,
    levels: int,
    boundary: str = "periodic",
) -> tuple[SlidingWindowState, MultiLevelMODWTResult]:
    """Multi-level window transform per push (processSample-cycle analogue)."""
    state = sliding_push(state, new_samples)
    return state, modwt_multilevel(
        state.window, wavelet, levels=levels, boundary=boundary
    )


def step_size(buffer_size: int, wavelet, *, levels: int = 1) -> int:
    """New samples consumed per transform: buffer_size - overlap, where
    overlap = filterLen-1 for single level and the cumulative cascade halo
    (L0-1)*(2^J - 1) for multi-level windows."""
    w = _resolve_discrete(wavelet)
    overlap = total_halo(w.filter_length, levels)
    if overlap >= buffer_size:
        raise InvalidArgumentError(
            ErrorCode.VAL_TOO_SHORT,
            f"buffer_size {buffer_size} must exceed the overlap {overlap}",
            suggestions=("Increase buffer_size or reduce levels",),
        )
    return buffer_size - overlap


class SlidingStreamingTransform:
    """Stateful wrapper with the reference's streaming ergonomics:
    ``process`` (arbitrary-length sample arrays), ``process_sample``,
    ``flush``, ``reset``, ``statistics``.

    Emits one window result per ``buffer_size - overlap`` new samples, first
    result once the buffer has filled (MODWTStreamingTransformImpl.java:45-120).
    """

    def __init__(
        self,
        wavelet="db4",
        *,
        buffer_size: int = 512,
        levels: int = 1,
        boundary: str = "periodic",
        batch_shape: tuple[int, ...] = (),
        dtype=jnp.float32,
    ) -> None:
        self.wavelet = _resolve_discrete(wavelet)
        self.levels = levels
        self.boundary = boundary
        self.buffer_size = buffer_size
        self.step = step_size(buffer_size, self.wavelet, levels=levels)
        self.overlap = buffer_size - self.step
        self._batch_shape = batch_shape
        self._dtype = dtype
        self.state = sliding_init(buffer_size, batch_shape=batch_shape, dtype=dtype)
        self._pending: list = []
        self._pending_count = 0
        self._need = buffer_size  # first cycle fills the whole buffer
        if levels == 1:
            self._xform = jax.jit(
                lambda st, blk: sliding_step(st, blk, self.wavelet, boundary=boundary)
            )
        else:
            self._xform = jax.jit(
                lambda st, blk: sliding_step_multilevel(
                    st, blk, self.wavelet, levels=levels, boundary=boundary
                )
            )
        self.samples_processed = 0
        self.windows_emitted = 0

    def _drain(self, results: list) -> None:
        while self._pending_count >= self._need:
            chunk = jnp.concatenate(self._pending, axis=-1)
            block, rest = chunk[..., : self._need], chunk[..., self._need :]
            self._pending = [rest] if rest.shape[-1] else []
            self._pending_count = int(rest.shape[-1])
            self.state, coeffs = self._xform(self.state, block)
            self._need = self.step  # subsequent cycles keep the overlap
            self.windows_emitted += 1
            results.append(coeffs)

    def process(self, samples) -> list:
        """Feed an arbitrary-length sample array; returns the list of window
        results that became ready (possibly empty)."""
        samples = jnp.asarray(samples, dtype=self._dtype)
        self._pending.append(samples)
        self._pending_count += samples.shape[-1]
        self.samples_processed += int(samples.shape[-1])
        results: list = []
        self._drain(results)
        return results

    def process_sample(self, sample):
        """Feed ONE sample; returns the window result if the cycle completed,
        else None (``processSample``)."""
        arr = jnp.asarray(sample, dtype=self._dtype).reshape(
            self._batch_shape + (1,)
        )
        out = self.process(arr)
        return out[-1] if out else None

    def flush(self):
        """Zero-pad the partial cycle and emit a final window (``flush``)."""
        if self._pending_count == 0:
            return None
        pad = self._need - self._pending_count
        zeros = jnp.zeros(self._batch_shape + (pad,), dtype=self._dtype)
        before = self.samples_processed  # padding is not real input
        results = self.process(zeros)
        self.samples_processed = before
        return results[-1] if results else None

    def reset(self) -> None:
        self.state = sliding_init(
            self.buffer_size, batch_shape=self._batch_shape, dtype=self._dtype
        )
        self._pending = []
        self._pending_count = 0
        self._need = self.buffer_size
        self.samples_processed = 0
        self.windows_emitted = 0

    @property
    def statistics(self) -> dict:
        return {
            "samples_processed": self.samples_processed,
            "windows_emitted": self.windows_emitted,
            "buffer_size": self.buffer_size,
            "overlap": self.overlap,
        }

"""Real-time ingest: native ring buffer -> batched sliding-window transforms.

The missing half of a real-time pipeline is host-side: a producer thread
(market feed, sensor DMA, socket reader) must hand samples to the device
consumer without locking it.  The reference does this with JVM threads and a
circular buffer (``MODWTStreamingTransformImpl.java:45-120``); here the
producer side is the native SPSC ring buffer (:mod:`vectorwave_tpu.native`)
and the consumer side drains *many* overlapping windows at once as ONE
``[k, buffer_size]`` device batch — a single jit dispatch transforms every
window that accumulated since the last drain.  Where dispatch latency
dominates, this batching is the difference between keeping up with a feed
and falling behind it.

Window semantics are identical to :mod:`vectorwave_tpu.streaming.sliding`:
the first window fills ``buffer_size`` samples, each later window advances
by ``step = buffer_size - overlap`` and re-covers the overlap, so
concatenating each window's trailing ``step`` interior coefficients
reproduces the whole-signal transform (same contract the sliding tests
assert).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..errors import ErrorCode, InvalidArgumentError
from ..native import RingBuffer
from ..transforms.cwt import _next_pow2
from ..transforms.modwt import _resolve_discrete, modwt
from ..transforms.multilevel import modwt_multilevel
from .sliding import step_size


class StreamIngest:
    """Producer/consumer bridge from a live sample feed to window transforms.

    Producer thread: :meth:`push` (wait-free in the native backend).
    Consumer thread: :meth:`drain` — assembles every ready overlapping
    window, transforms them as one batch, and returns the coefficient
    pytree with a leading window axis (or ``None`` when nothing is ready).

    Batch shapes are bucketed to powers of two (zero-padded, then sliced
    back) so a live feed with a varying backlog compiles O(log k) programs,
    not one per backlog size.
    """

    def __init__(
        self,
        wavelet="db4",
        *,
        buffer_size: int = 512,
        levels: int = 1,
        boundary: str = "periodic",
        channels: int = 1,
        capacity: int | None = None,
        dtype=np.float32,
        backend: str | None = None,
    ) -> None:
        self.wavelet = _resolve_discrete(wavelet)
        self.levels = int(levels)
        self.boundary = boundary
        self.buffer_size = int(buffer_size)
        self.step = step_size(buffer_size, self.wavelet, levels=self.levels)
        self.overlap = self.buffer_size - self.step
        self.channels = int(channels)
        if capacity is None:
            capacity = 64 * self.buffer_size
        if capacity < self.buffer_size:
            raise InvalidArgumentError(
                ErrorCode.VAL_TOO_SHORT,
                f"capacity {capacity} must hold at least one window "
                f"({self.buffer_size})",
            )
        self.ring = RingBuffer(
            capacity, channels=channels, dtype=dtype, backend=backend
        )
        if self.levels == 1:
            fn = lambda w: modwt(w, self.wavelet, boundary=boundary)  # noqa: E731
        else:
            fn = lambda w: modwt_multilevel(  # noqa: E731
                w, self.wavelet, levels=self.levels, boundary=boundary
            )
        self._xform = jax.jit(fn)
        self.windows_emitted = 0
        self.samples_transformed = 0

    # -- producer side -------------------------------------------------------
    def push(self, samples) -> int:
        """Append samples ([n] or [n, channels]); returns ticks accepted."""
        return self.ring.push(samples)

    # -- consumer side -------------------------------------------------------
    @property
    def ready(self) -> int:
        """Windows that :meth:`drain` would emit right now."""
        avail = self.ring.available
        if avail < self.buffer_size:
            return 0
        return 1 + (avail - self.buffer_size) // self.step

    def drain(self, max_frames: int | None = None):
        """Transform every ready window in one dispatch.

        Returns the coefficient pytree with a leading ``[k]`` window axis
        (channels > 1 adds a ``[channels]`` axis after it), or ``None`` when
        no window is ready yet.
        """
        limit = max_frames if max_frames is not None else 2**31
        frames = self.ring.pop_frames(self.buffer_size, self.step, limit)
        k = frames.shape[0]
        if k == 0:
            return None
        if self.channels > 1:
            frames = np.moveaxis(frames, -1, 1)  # [k, channels, time]
        bucket = _next_pow2(k)
        if bucket != k:
            pad = np.zeros((bucket - k,) + frames.shape[1:], frames.dtype)
            frames = np.concatenate([frames, pad], axis=0)
        coeffs = self._xform(jnp.asarray(frames))
        self.windows_emitted += k
        self.samples_transformed += k * self.buffer_size
        if bucket != k:
            coeffs = jax.tree.map(lambda a: a[:k], coeffs)
        return coeffs

    def latest_window(self) -> np.ndarray | None:
        """The newest ``buffer_size`` samples without consuming (monitors)."""
        out = self.ring.peek_latest(self.buffer_size)
        return out if out.shape[0] == self.buffer_size else None

    @property
    def statistics(self) -> dict:
        return {
            "backend": self.ring.backend,
            "queued": self.ring.available,
            "dropped": self.ring.dropped,
            "ready": self.ready,
            "windows_emitted": self.windows_emitted,
            "samples_transformed": self.samples_transformed,
            "buffer_size": self.buffer_size,
            "overlap": self.overlap,
        }

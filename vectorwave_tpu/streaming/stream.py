"""Block-streaming MODWT with explicit carry state.

Re-design of the reference's streaming transforms
(``/root/reference/vectorwave-core/.../modwt/streaming/MODWTStreamingTransformImpl.java``,
``MultiLevelMODWTStreamingTransform.java`` and the extensions'
``BatchStreamingMODWT.java:19-458`` /
``BatchSIMDMODWT.generalBatchMODWTSoAWithScaledFiltersAndHistory`` :447-508):

* The Flow.Publisher + ring-buffer machinery becomes a pure transition
  function ``state, block -> state, coefficients`` whose carry is a pytree —
  jit/scan-friendly and trivially batched over leading axes.
* Per level j the carry holds the last ``(L0-1) * 2^(j-1)`` samples of that
  level's input stream (the reference's "left history" of length L_j - 1);
  negative convolution indices read from it, which makes block-wise output
  BIT-IDENTICAL to the whole-signal transform for ZERO_PADDING and SYMMETRIC
  boundaries.  PERIODIC processes each block circularly (stateless), matching
  the reference.
* This same history mechanism is the intra-host half of the long-signal
  story; ``vectorwave_tpu.parallel`` uses the identical halo contract across
  chips via collectives.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax.numpy as jnp

from ..errors import ErrorCode, InvalidArgumentError
from ..ops.convolve import atrous_analysis_pair, effective_length
from ..transforms.modwt import _resolve_discrete
from ..transforms.multilevel import MultiLevelMODWTResult

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


class StreamingState(NamedTuple):
    """Carry: per-level left-history buffers (level-j input stream tails)."""

    histories: tuple[jnp.ndarray, ...]
    blocks_processed: jnp.ndarray  # scalar int32 — first-block detection


def history_length(filter_length: int, level: int) -> int:
    """(L0-1) * 2^(j-1) = L_j - 1 (BatchStreamingMODWT.getHistoryLengthForLevel)."""
    return effective_length(filter_length, level) - 1


def suggest_flush_tail_length(wavelet, levels: int) -> int:
    """Tail needed to drain all levels (BatchStreamingMODWT.suggestFlushTailLength)."""
    w = _resolve_discrete(wavelet)
    return history_length(w.filter_length, levels)


def streaming_init(
    wavelet,
    levels: int,
    *,
    batch_shape: tuple[int, ...] = (),
    dtype=jnp.float32,
) -> StreamingState:
    """Zero-history initial state (zero-padding parity for the first block)."""
    if levels < 1:
        from ..errors import ErrorCode, InvalidArgumentError

        raise InvalidArgumentError(
            ErrorCode.VAL_INVALID_LEVEL,
            f"levels must be >= 1, got {levels}",
        )
    w = _resolve_discrete(wavelet)
    histories = tuple(
        jnp.zeros(batch_shape + (history_length(w.filter_length, j),), dtype=dtype)
        for j in range(1, levels + 1)
    )
    return StreamingState(histories, jnp.zeros((), dtype=jnp.int32))


def modwt_stream_block(
    state: StreamingState,
    block: jnp.ndarray,
    wavelet,
    *,
    boundary: str = "zero",
) -> tuple[StreamingState, MultiLevelMODWTResult]:
    """Process one block; returns (new_state, block coefficients).

    For ``zero``/``symmetric`` boundaries the concatenated per-block outputs
    equal the whole-signal transform exactly (left-history contract).  For
    ``symmetric`` the reference mirrors the FIRST block into the history
    (``BatchStreamingMODWT.java:74-95``); here that is expressed with a
    ``lax.select`` on ``blocks_processed`` so the step stays jittable.
    ``periodic`` treats each block circularly and keeps no state.
    """
    w = _resolve_discrete(wavelet)
    levels = len(state.histories)
    boundary_l = boundary.lower()
    low = w.dec_lo * _INV_SQRT2
    high = w.dec_hi * _INV_SQRT2

    if boundary_l.startswith("per"):
        current = block
        details = []
        for level in range(1, levels + 1):
            current, detail = atrous_analysis_pair(
                current, low, high, spacing=1 << (level - 1), boundary="periodic"
            )
            details.append(detail)
        new_state = StreamingState(state.histories, state.blocks_processed + 1)
        return new_state, MultiLevelMODWTResult(tuple(details), current)

    if boundary_l not in ("zero", "zero_padding", "symmetric", "sym"):
        raise InvalidArgumentError(
            ErrorCode.CFG_UNSUPPORTED_BOUNDARY,
            f"Unsupported streaming boundary: {boundary!r}",
            suggestions=("Use 'zero', 'symmetric' or 'periodic'",),
        )
    symmetric = boundary_l.startswith("sym")

    current = block
    details = []
    new_histories = []
    is_first = state.blocks_processed == 0
    for level in range(1, levels + 1):
        spacing = 1 << (level - 1)
        hist_len = history_length(w.filter_length, level)
        history = state.histories[level - 1]
        if symmetric and hist_len > 0:
            # first block: history = mirror of the block head (whole-signal
            # symmetric-extension parity); later blocks: the carried tail
            n_cur = current.shape[-1]
            reps = -(-hist_len // max(n_cur, 1))
            ext_src = current
            if reps > 1:  # block shorter than the history: tile reflections
                tiles = []
                flip = True
                for _ in range(reps):
                    tiles.append(jnp.flip(ext_src, axis=-1) if flip else ext_src)
                    flip = not flip
                mirror_full = jnp.concatenate(tiles[::-1], axis=-1)
            else:
                mirror_full = jnp.flip(ext_src, axis=-1)
            mirror = mirror_full[..., -hist_len:] if hist_len else mirror_full[..., :0]
            history = jnp.where(is_first, mirror, history)
        ext = jnp.concatenate([history, current], axis=-1)
        approx, detail = atrous_analysis_pair(
            ext, low, high, spacing=spacing, boundary="zero"
        )
        n_block = current.shape[-1]
        details.append(detail[..., -n_block:])
        if hist_len > 0:
            new_histories.append(ext[..., -hist_len:])
        else:
            new_histories.append(ext[..., :0])
        current = approx[..., -n_block:]
    new_state = StreamingState(tuple(new_histories), state.blocks_processed + 1)
    return new_state, MultiLevelMODWTResult(tuple(details), current)


def modwt_stream_flush(
    state: StreamingState,
    wavelet,
    tail_length: int | None = None,
    *,
    boundary: str = "zero",
) -> tuple[StreamingState, MultiLevelMODWTResult]:
    """Drain the carried history by processing a zero tail
    (``flushMultiLevel`` — BatchStreamingMODWT.java:181-258)."""
    levels = len(state.histories)
    if tail_length is None:
        tail_length = suggest_flush_tail_length(wavelet, levels)
    batch_shape = state.histories[0].shape[:-1]
    zeros = jnp.zeros(batch_shape + (tail_length,), dtype=state.histories[0].dtype)
    return modwt_stream_block(state, zeros, wavelet, boundary=boundary)


class StreamingTransform:
    """Convenience stateful wrapper with reference-like ergonomics
    (``MODWTStreamingTransform`` / ``MultiLevelMODWTStreamingTransform``:
    process/flush/reset plus running statistics).  Holds the functional carry
    and a jitted per-block transition; the Flow.Publisher protocol becomes
    ordinary return values (compose with any Python iterator/async pipeline).
    """

    def __init__(
        self,
        wavelet="db4",
        *,
        levels: int = 1,
        boundary: str = "zero",
        batch_shape: tuple[int, ...] = (),
        dtype=jnp.float32,
        backend: str | None = None,
    ) -> None:
        import jax

        from ..transforms.multilevel import _check_backend

        _check_backend(backend)
        self.wavelet = _resolve_discrete(wavelet)
        self.levels = levels
        self.boundary = boundary
        self._batch_shape = batch_shape
        self._dtype = dtype
        self.state = streaming_init(
            self.wavelet, levels, batch_shape=batch_shape, dtype=dtype
        )
        self._step = jax.jit(
            lambda st, blk: modwt_stream_block(
                st, blk, self.wavelet, boundary=boundary
            )
        )
        self.samples_processed = 0
        self.blocks_processed = 0

    def process(self, block) -> MultiLevelMODWTResult:
        """Transform one block; returns its coefficients (``process``)."""
        self.state, coeffs = self._step(self.state, jnp.asarray(block, dtype=self._dtype))
        self.samples_processed += int(coeffs.approx.shape[-1])
        self.blocks_processed += 1
        return coeffs

    def flush(self, tail_length: int | None = None) -> MultiLevelMODWTResult:
        """Drain the carried history (``flush``)."""
        self.state, coeffs = modwt_stream_flush(
            self.state, self.wavelet, tail_length, boundary=self.boundary
        )
        self.blocks_processed += 1
        return coeffs

    def reset(self) -> None:
        """Clear all history (``reset``)."""
        self.state = streaming_init(
            self.wavelet, self.levels, batch_shape=self._batch_shape, dtype=self._dtype
        )
        self.samples_processed = 0
        self.blocks_processed = 0

    @property
    def statistics(self) -> dict:
        """Samples/blocks counters (the LongAdder statistics analogue)."""
        return {
            "samples_processed": self.samples_processed,
            "blocks_processed": self.blocks_processed,
        }

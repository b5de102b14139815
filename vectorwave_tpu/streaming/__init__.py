from .stream import (
    StreamingState,
    StreamingTransform,
    modwt_stream_block,
    modwt_stream_flush,
    streaming_init,
    suggest_flush_tail_length,
)
from .sliding import (
    SlidingStreamingTransform,
    SlidingWindowState,
    sliding_init,
    sliding_push,
    sliding_step,
    sliding_step_multilevel,
    step_size,
)
from .ingest import StreamIngest
from .denoiser_stream import (
    StreamingDenoiser,
    StreamingDenoiserState,
    streaming_denoiser_init,
    streaming_denoise_block,
)

__all__ = [
    "StreamingState",
    "StreamingTransform",
    "streaming_init",
    "modwt_stream_block",
    "modwt_stream_flush",
    "suggest_flush_tail_length",
    "SlidingStreamingTransform",
    "SlidingWindowState",
    "sliding_init",
    "sliding_push",
    "sliding_step",
    "sliding_step_multilevel",
    "step_size",
    "StreamIngest",
    "StreamingDenoiserState",
    "streaming_denoiser_init",
    "streaming_denoise_block",
    "StreamingDenoiser",
]

"""Logging, metrics and profiling hooks.

Re-design of the reference's observability tier
(``util/Logging.java`` System.Logger wrapper + ``-Dvectorwave.log.level``;
streaming LongAdder statistics ``MODWTStreamingTransformImpl.java:66-70``;
``ParallelConfig.ExecutionStats``): standard :mod:`logging` with an env-var
level, a tiny thread-safe counter registry, and a ``jax.profiler`` trace
context for device profiling (the analogue of the JMH module's offline
profiling role).
"""

from __future__ import annotations

import contextlib
import logging
import os
import subprocess
import tempfile
import threading
import time

logger = logging.getLogger("vectorwave_tpu")
_level = os.environ.get("VECTORWAVE_TPU_LOG_LEVEL")
if _level:
    logger.setLevel(getattr(logging, _level.upper(), logging.INFO))


class Stats:
    """Thread-safe counters (the LongAdder statistics analogue)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}

    def add(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def get(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()


#: process-global stats registry
stats = Stats()


@contextlib.contextmanager
def throughput_meter(name: str, samples: int):
    """Measure a block and record samples/sec into :data:`stats`."""
    start = time.perf_counter()
    yield
    elapsed = time.perf_counter() - start
    stats.add(f"{name}.samples", samples)
    stats.add(f"{name}.seconds", elapsed)
    logger.debug("%s: %.0f samples/s", name, samples / max(elapsed, 1e-12))


@contextlib.contextmanager
def profiler_trace(log_dir: str | None = None):
    """Capture a jax.profiler trace around a block (TensorBoard-viewable);
    by default into ``vectorwave_tpu_trace`` under the temp directory."""
    import jax

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "vectorwave_tpu_trace")

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def card_description() -> str:
    """``name, power.limit`` of every NVIDIA card, from ``nvidia-smi`` in a
    child process (never JAX, so it cannot take a card's memory); cards are
    joined with ``"; "``.  Printed beside every device time, because a card
    set below its power limit runs slower under load."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return "; ".join(
        line.strip() for line in out.stdout.splitlines() if line.strip()
    )

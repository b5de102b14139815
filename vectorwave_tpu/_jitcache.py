"""Bounded FIFO cache for compiled-program handles.

Module-level jit caches keyed by (shape, dtype, config) grow without bound
in a long-lived serving process that sees many distinct shapes — each entry
pins a compiled XLA program plus its closure.  This tiny dict
subclass evicts oldest-first at a fixed capacity; XLA's own executable
cache policy then governs the real memory.
"""

from __future__ import annotations


class BoundedCache(dict):
    """dict with FIFO eviction at ``maxsize`` (insertion-ordered)."""

    def __init__(self, maxsize: int = 128):
        super().__init__()
        self.maxsize = maxsize

    def __setitem__(self, key, value):
        if key not in self and len(self) >= self.maxsize:
            del self[next(iter(self))]
        super().__setitem__(key, value)

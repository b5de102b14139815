"""Global configuration.

Re-design of the reference's configuration surface
(``wavelet/config/TransformConfig.java:54-222`` builder and the
``vectorwave.*`` system properties, docs/CONFIGURATION.md): a small dataclass
plus module-level knobs.  The reference's ``forceScalar`` flag maps to
``backend='jnp'``, which is the same XLA path as ``'auto'``; the FFT heuristics
knobs map to the CWT engine; the runtime-learning estimator is replaced by a
static cost model (XLA compiles; there is nothing to learn at runtime) — see
``cost_model``.
"""

from __future__ import annotations

import dataclasses
import os

_VALID_BACKENDS = ("auto", "jnp")

_backend = "auto"


def set_backend(name: str) -> None:
    """Select the compute backend: ``auto`` or ``jnp`` (the same XLA path;
    the name is kept for configuration files written for older releases)."""
    if name not in _VALID_BACKENDS:
        from .errors import ErrorCode, InvalidConfigurationError

        raise InvalidConfigurationError(
            ErrorCode.CFG_INVALID_CONFIG,
            f"Unknown backend {name!r}",
            suggestions=(f"Use one of {_VALID_BACKENDS}",),
        )
    global _backend
    _backend = name


def get_backend() -> str:
    return _backend


_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cache_root() -> str:
    """Root directory for on-disk caches (native builds, perf calibration):
    ``$VECTORWAVE_TPU_CACHE`` or ``.cache`` inside the checkout."""
    return os.environ.get("VECTORWAVE_TPU_CACHE", os.path.join(_CHECKOUT, ".cache"))


#: Compile-cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is unset:
#: one fixed path inside the checkout (listed in ``.gitignore``), so every
#: process of this repository finds the programs the others compiled.
DEFAULT_COMPILATION_CACHE_DIR = os.path.join(_CHECKOUT, ".jax_cache")


def enable_compilation_cache() -> str:
    """Persist XLA compilations across processes; returns the directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and this
    sets no other directory; otherwise the cache goes to
    :data:`DEFAULT_COMPILATION_CACHE_DIR`.  Call once at startup (the
    benchmarks, ``chip_smoke.py`` and the test suite do).
    """
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_COMPILATION_CACHE_DIR
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


@dataclasses.dataclass(frozen=True)
class TransformConfig:
    """Bundle of transform options (reference: TransformConfig builder).

    ``boundary``: periodic / zero / symmetric.
    ``backend``: auto / jnp (force_scalar <-> backend='jnp').
    ``max_decomposition_levels``: safety cap (reference default 20; the
    multi-level transform itself caps at 10).
    """

    boundary: str = "periodic"
    backend: str = "auto"
    max_decomposition_levels: int = 20

"""Wavelet registry: name -> wavelet resolution plus family/compat queries.

Re-design of the reference registry
(``/root/reference/vectorwave-core/.../wavelet/api/WaveletRegistry.java:18-412``
and ``WaveletName.java``): instead of a mutable ConcurrentHashMap populated by
static initializers and ServiceLoader providers, this is a plain dict of lazy
factories keyed by lowercase string names (PyWavelets-compatible), with results
memoized.  Extension packages register additional factories via
:func:`register_wavelet` (the SPI analogue of ``WaveletProvider``).
"""

from __future__ import annotations

import functools
from typing import Callable

from ..errors import ErrorCode, InvalidArgumentError
from .base import ContinuousWavelet, DiscreteWavelet, TransformType, Wavelet, WaveletType
from . import orthogonal

_FACTORIES: dict[str, Callable[[], Wavelet]] = {}
_ALIASES: dict[str, str] = {}


def register_wavelet(name: str, factory: Callable[[], Wavelet]) -> None:
    """Register a wavelet factory (SPI plug-in point, cf. WaveletProvider.java)."""
    _FACTORIES[name.lower()] = factory
    wavelet.cache_clear()


def register_alias(alias: str, target: str) -> None:
    _ALIASES[alias.lower()] = target.lower()


def _register_builtins() -> None:
    from . import biorthogonal as bior
    from . import coiflets, fourier_families

    _FACTORIES["haar"] = orthogonal.haar
    _ALIASES["db1"] = "haar"
    # Daubechies db2..db38 (reference ships even orders 2..38,
    # Daubechies.java:61-305; we also generate the odd orders).
    for order in range(2, 39):
        _FACTORIES[f"db{order}"] = functools.partial(orthogonal.daubechies, order)
    # Symlets sym2..sym20 (Symlet.java).
    for order in range(2, 21):
        _FACTORIES[f"sym{order}"] = functools.partial(orthogonal.symlet, order)
    # Coiflets coif1..coif17 (Coiflet.java).
    for order in range(1, coiflets.MAX_ORDER + 1):
        _FACTORIES[f"coif{order}"] = functools.partial(coiflets.coiflet, order)
    # Biorthogonal / reverse biorthogonal splines (BiorthogonalSpline.java,
    # ReverseBiorthogonalSpline.java).
    for nr, nd in bior.VARIANTS:
        _FACTORIES[f"bior{nr}.{nd}"] = functools.partial(bior.biorthogonal, nr, nd)
        _FACTORIES[f"rbio{nr}.{nd}"] = functools.partial(
            bior.reverse_biorthogonal, nr, nd
        )
    # Discrete Meyer + Battle-Lemarié (DiscreteMeyer.java, BattleLemarieWavelet.java).
    _FACTORIES["dmey"] = fourier_families.discrete_meyer
    for order in range(1, 6):
        _FACTORIES[f"blem{order}"] = functools.partial(
            fourier_families.battle_lemarie, order
        )
    # Continuous wavelets (cwt/*.java, cwt/finance/*.java).
    from . import continuous

    continuous.register_continuous(
        lambda name, factory: _FACTORIES.__setitem__(name, factory),
        lambda alias, target: _ALIASES.__setitem__(alias, target),
    )


_register_builtins()


@functools.lru_cache(maxsize=None)
def wavelet(name: str) -> Wavelet:
    """Resolve a wavelet by name (case-insensitive)."""
    key = name.lower()
    key = _ALIASES.get(key, key)
    factory = _FACTORIES.get(key)
    if factory is None:
        close = [n for n in sorted(_FACTORIES) if n[:2] == key[:2]][:8]
        raise InvalidArgumentError(
            ErrorCode.CFG_UNSUPPORTED_WAVELET,
            f"Unknown wavelet: {name!r}",
            context={"requested": name},
            suggestions=(
                f"Known wavelets with similar names: {close}" if close else
                "Call vectorwave_tpu.available_wavelets() for the full list",
            ),
        )
    return factory()


def as_wavelet(spec: str | Wavelet) -> Wavelet:
    """Accept either a wavelet object or a registry name."""
    if isinstance(spec, (DiscreteWavelet, ContinuousWavelet)):
        return spec
    return wavelet(spec)


def available_wavelets() -> list[str]:
    """All registered wavelet names, sorted."""
    return sorted(set(_FACTORIES) | set(_ALIASES))


def wavelets_of_type(wtype: WaveletType) -> list[str]:
    """Names of registered wavelets of the given type (family queries,
    cf. WaveletRegistry.getOrthogonalWavelets :199)."""
    return [n for n in sorted(_FACTORIES) if wavelet(n).wavelet_type is wtype]


#: short registry prefixes accepted as family aliases (PyWavelets-style)
_FAMILY_SHORT = {
    "db": "daubechies",
    "sym": "symlet",
    "coif": "coiflet",
    "bior": "biorthogonalspline",
    "rbio": "reversebiorthogonalspline",
    "blem": "battlelemarie",
    "dmey": "discretemeyer",
}


def wavelets_in_family(family: str) -> list[str]:
    """Names in a family; accepts the full family name ('Daubechies') or the
    short name prefix ('db') (cf. getDaubechiesWavelets :260)."""
    fam = family.lower()
    fam = _FAMILY_SHORT.get(fam, fam)
    return [n for n in sorted(_FACTORIES) if wavelet(n).family.lower() == fam]


def supported_transforms(name: str | Wavelet) -> tuple[TransformType, ...]:
    """Transform-compatibility matrix (WaveletRegistry.getSupportedTransforms :314)."""
    w = as_wavelet(name)
    if isinstance(w, DiscreteWavelet):
        return (TransformType.MODWT, TransformType.SWT)
    return (TransformType.CWT,)


def is_compatible(name: str | Wavelet, transform: TransformType) -> bool:
    """Whether a wavelet supports a transform (WaveletRegistry.isCompatible :338)."""
    return transform in supported_transforms(name)


def recommended_transform(name: str | Wavelet) -> TransformType:
    """Best default transform for a wavelet (getRecommendedTransform :370)."""
    w = as_wavelet(name)
    if isinstance(w, DiscreteWavelet):
        return TransformType.MODWT
    return TransformType.CWT

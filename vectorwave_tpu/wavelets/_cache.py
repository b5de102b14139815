"""Filter coefficients of the built-in discrete families.

Generating a filter (spectral factorization at 80 digits, Gauss-Newton
refinement) needs ``mpmath`` and takes up to seconds per order, so the float64
coefficients of every built-in family are committed in :mod:`._tables`,
written by ``tools/gen_filter_tables.py`` from :func:`builtin_generators`.
A key outside the table (for example a Battle-Lemarié filter at a
non-default length) is generated on request.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np


def cached_filter(key: str, generate: Callable[[], np.ndarray]) -> np.ndarray:
    """The committed coefficients for ``key``, else ``generate()``."""
    from ._tables import FILTERS

    coeffs = FILTERS.get(key)
    if coeffs is None:
        return np.asarray(generate(), dtype=np.float64)
    return np.array(coeffs, dtype=np.float64)


def builtin_generators() -> dict[str, Callable[[], np.ndarray]]:
    """Table key -> generator for every filter the registry builds."""
    from . import biorthogonal, coiflets, fourier_families, orthogonal

    gens: dict[str, Callable[[], np.ndarray]] = {}
    for p in range(2, 39):
        gens[f"db{p}"] = functools.partial(orthogonal._daubechies_generate, p)
    for p in range(2, 21):
        gens[f"sym{p}"] = functools.partial(orthogonal._symlet_filter_uncached, p)
    for order in range(1, coiflets.MAX_ORDER + 1):
        gens[f"coif{order}"] = functools.partial(coiflets._coiflet_generate, order)
    for nr, nd in biorthogonal.VARIANTS:
        gens[f"bior{nr}.{nd}"] = functools.partial(
            biorthogonal._biorthogonal_generate, nr, nd
        )
    gens["dmey62"] = functools.partial(fourier_families._dmey_generate, 62)
    for order in range(1, 6):
        length = 4 * (order + 1)
        gens[f"blem{order}_{length}"] = functools.partial(
            fourier_families._battle_lemarie_generate, order, length
        )
    return gens

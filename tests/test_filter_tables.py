"""The committed filter table equals its generators, and the registry
resolves every name without ``mpmath``.

``vectorwave_tpu/wavelets/_tables.py`` is written by
``tools/gen_filter_tables.py``; ``import vectorwave_tpu`` must work on a
machine without ``mpmath`` (the generators need it, the table does not).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import vectorwave_tpu as vw
from vectorwave_tpu.wavelets import coiflets
from vectorwave_tpu.wavelets._cache import builtin_generators
from vectorwave_tpu.wavelets._tables import FILTERS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: keys whose generator takes seconds (high-order coiflet Gauss-Newton at
#: 50 digits); the table entry is checked against the defining equations
SLOW_KEYS = tuple(f"coif{k}" for k in range(10, coiflets.MAX_ORDER + 1))
GENERATED_KEYS = tuple(k for k in builtin_generators() if k not in SLOW_KEYS)


def test_table_covers_every_generator():
    assert set(FILTERS) == set(builtin_generators())


@pytest.mark.parametrize("key", GENERATED_KEYS)
def test_table_equals_regenerated(key):
    want = np.asarray(builtin_generators()[key](), np.float64)
    got = np.asarray(FILTERS[key], np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)


@pytest.mark.parametrize("key", SLOW_KEYS)
def test_slow_table_entries_satisfy_coiflet_equations(key):
    order = int(key[len("coif"):])
    h = np.asarray(FILTERS[key], np.float64)
    assert h.shape == (6 * order,)
    tau = coiflets._moment_center(h)
    assert coiflets._max_scaled_residual(h, order, tau) <= 1e-13
    seed = np.asarray(coiflets.SEEDS[order], np.float64)
    assert np.max(np.abs(h - seed)) < 1e-3  # refined from the published seed


_BLOCKED_IMPORT = r"""
import json, sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name == "mpmath" or name.startswith("mpmath."):
            raise ImportError("mpmath blocked")
sys.meta_path.insert(0, _Block())
sys.modules.pop("mpmath", None)
import vectorwave_tpu as vw
out = {}
for name in vw.available_wavelets():
    try:
        w = vw.wavelet(name)
        out[name] = "ok" if w is not None else "none"
    except Exception as exc:
        out[name] = f"{type(exc).__name__}: {exc}"
out["__mpmath_loaded__"] = "mpmath" in sys.modules
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def resolved_without_mpmath():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_import_without_mpmath_never_loads_it(resolved_without_mpmath):
    assert resolved_without_mpmath["__mpmath_loaded__"] is False


@pytest.mark.parametrize("name", vw.available_wavelets())
def test_wavelet_resolves_without_mpmath(resolved_without_mpmath, name):
    assert resolved_without_mpmath[name] == "ok"

"""Write ``vectorwave_tpu/wavelets/_tables.py``: the float64 coefficients of
every built-in discrete wavelet family, regenerated from their defining
constructions (needs ``mpmath``; takes about two minutes).

    python tools/gen_filter_tables.py
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

from vectorwave_tpu.wavelets._cache import builtin_generators  # noqa: E402

TARGET = os.path.join(ROOT, "vectorwave_tpu", "wavelets", "_tables.py")

HEADER = '''"""Float64 filter coefficients of the built-in discrete wavelet families.

Generated by ``tools/gen_filter_tables.py`` from the generators in this
package; do not edit by hand.  Keys are those of
:func:`vectorwave_tpu.wavelets._cache.builtin_generators`.
"""

FILTERS: dict[str, tuple[float, ...]] = {
'''


def render(tables: dict[str, list[float]]) -> str:
    lines = [HEADER]
    for key, coeffs in tables.items():
        lines.append(f"    {key!r}: (\n")
        for c in coeffs:
            lines.append(f"        {float(c)!r},\n")
        lines.append("    ),\n")
    lines.append("}\n")
    return "".join(lines)


def main() -> None:
    tables = {}
    for key, generate in builtin_generators().items():
        tables[key] = [float(c) for c in generate()]
        print(key, len(tables[key]), flush=True)
    with open(TARGET, "w") as f:
        f.write(render(tables))
    print(f"wrote {TARGET}")


if __name__ == "__main__":
    main()

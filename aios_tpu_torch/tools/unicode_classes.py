#!/usr/bin/env python3
"""Write ``aios_tpu_torch/engine/unicode_classes.py``: the code point ranges
of the ``regex`` package's ``\\p{L}``, ``\\p{N}`` and ``\\s``, which the
byte-level BPE pretokenizer (``tokenizer._compile_pre``) spells out for the
standard library's ``re``. The JAX package pretokenizes with ``regex``; the
port reads the table this script writes and imports no ``regex`` at run
time. Rerun it after a ``regex`` upgrade (the table names the version it
was taken from):
    python3 aios_tpu_torch/tools/unicode_classes.py
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Tuple

import regex

OUT = Path(__file__).resolve().parents[1] / "engine" / "unicode_classes.py"
MAX_UNICODE = 0x10FFFF


def class_ranges(pattern: str) -> List[Tuple[int, int]]:
    """Inclusive (first, last) code point runs that ``pattern`` matches."""
    compiled = regex.compile(pattern)
    out: List[List[int]] = []
    for cp in range(MAX_UNICODE + 1):
        if compiled.match(chr(cp)):
            if out and out[-1][1] == cp - 1:
                out[-1][1] = cp
            else:
                out.append([cp, cp])
    return [(a, b) for a, b in out]


def _table(name: str, ranges: List[Tuple[int, int]]) -> str:
    rows = [f"    (0x{a:04X}, 0x{b:04X})," for a, b in ranges]
    return f"{name} = (\n" + "\n".join(rows) + "\n)\n"


def main() -> None:
    classes = {"LETTER": r"\p{L}", "NUMBER": r"\p{N}", "WHITE_SPACE": r"\s"}
    parts = [
        '"""Code point ranges of the ``regex`` package\'s \\\\p{L}, \\\\p{N} and \\\\s,\n'
        f"taken from regex {regex.__version__} by ``aios_tpu_torch/tools/unicode_classes.py``;\n"
        'do not edit by hand. Inclusive (first, last) pairs in code point order."""\n',
        f'REGEX_VERSION = "{regex.__version__}"\n',
    ]
    for name, pattern in classes.items():
        parts.append(_table(name, class_ranges(pattern)))
    OUT.write_text("\n".join(parts))
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()

"""Compact string-grid tableau format: parse and serialize.

A copy of ``tpulp.io.grid`` with the same code (``tests/test_torch_model.py``
holds the two equal); ``python -m tpulp_torch render --format grid``
prints it. A whitespace tableau literal is the most readable way to write
golden tableau states.

Format (whitespace separated, ``#`` comments, blank lines ignored)::

    x1    x2    _s0  _s1  | z
    -40   -30   0    0    | 0
    1     1     1    0    | 12
    2     1     0    1    | 16

* line 1: variable names, wrapping a name in parens marks it basic: ``(x1)``
* line 2: objective row; the value after ``|`` is the RAW corner value, i.e.
  ``-z`` (matching the JSON schema's ``z`` field and the internal layout)
* remaining lines: constraint rows with the RHS after ``|``
* the ``|`` separators are optional; values may be ints or ``p/q`` strings
"""

from __future__ import annotations

from typing import List

from ..tableau import Tableau

__all__ = ["parse_grid", "format_grid"]


def _tokens(line: str) -> List[str]:
    line = line.split("#", 1)[0]
    return [t for t in line.replace("|", " ").split() if t]


def parse_grid(text: str) -> Tableau:
    """Parse the string-grid format into a Tableau."""
    rows = [toks for toks in (_tokens(ln) for ln in text.splitlines()) if toks]
    if len(rows) < 3:
        raise ValueError("grid needs a header, an objective row and >=1 constraint row")
    header = rows[0]
    if header and header[-1] == "z":
        header = header[:-1]
    names: List[str] = []
    marks: List[bool] = []
    for tok in header:
        if tok.startswith("(") and tok.endswith(")"):
            names.append(tok[1:-1])
            marks.append(True)
        else:
            names.append(tok)
            marks.append(False)
    n = len(names)
    body = rows[1:]
    m = len(body) - 1
    for k, row in enumerate(body):
        if len(row) != n + 1:
            raise ValueError(
                f"row {k}: expected {n + 1} values, got {len(row)}: {row}")
    tab = Tableau(m, n)
    tab.setVarNames(names)
    tab.setVarMarks(marks)
    tab.setC(body[0][:-1])
    # corner token is the RAW stored value (-z): negate for setZ
    from fractions import Fraction

    tab.setZ(-Fraction(body[0][-1]))
    for i in range(m):
        tab.setBi(i, body[1 + i][-1])
        for j in range(n):
            tab.setAij(i, j, body[1 + i][j])
    return tab


def format_grid(tab: Tableau) -> str:
    """Serialize a Tableau to the string-grid format (parse round-trips)."""
    from .render import render_grid

    cells = render_grid(tab, labels=True, rownums=False)
    widths = [max(len(row[j]) for row in cells) for j in range(len(cells[0]))]
    lines = []
    for row in cells:
        parts = [f"{row[j]:>{widths[j]}}" for j in range(len(row) - 1)]
        parts.append("|")
        parts.append(row[-1])
        lines.append("  ".join(parts))
    return "\n".join(lines)

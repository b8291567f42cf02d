"""Tableau rendering: string grid, boxed text, LaTeX, CSV.

Observability parity with the reference (tableau.py:362-455): marked (basic)
variables render wrapped in parentheses; the objective row is on top and the
RHS is the last column.
"""

from __future__ import annotations

import csv
import io as _io
from typing import List

__all__ = ["render_grid", "render_text", "render_latex", "render_csv"]


def _cells(tab, labels: bool, rownums: bool) -> List[List[str]]:
    """Raw string cells: optional header row of var names (+'z'), then the
    objective row, then constraint rows; optional leading row-number column."""
    m, n = tab.getTableauSize()
    names = tab.getVarNames()
    marks = tab.getVarMarks()
    grid: List[List[str]] = []
    if labels:
        head = []
        if rownums:
            head.append("")
        for j in range(n):
            name = names[j] if names[j] else f"x{j}"
            head.append(f"({name})" if marks[j] else name)
        head.append("z")
        grid.append(head)
    obj = []
    if rownums:
        obj.append("obj")
    obj.extend(str(tab.getCj(j)) for j in range(n))
    obj.append(str(-tab.getZ()))
    grid.append(obj)
    for i in range(m):
        row = []
        if rownums:
            row.append(str(i))
        row.extend(str(tab.getAij(i, j)) for j in range(n))
        row.append(str(tab.getBi(i)))
        grid.append(row)
    return grid


def render_grid(tab, labels: bool = True, rownums: bool = True) -> List[List[str]]:
    """2-D list of string cells (the reference's printGrid contract)."""
    return _cells(tab, labels, rownums)


def render_text(tab, labels: bool = True, rownums: bool = False) -> str:
    """Boxed, column-aligned terminal table."""
    cells = _cells(tab, labels, rownums)
    ncols = len(cells[0])
    widths = [max(len(row[j]) for row in cells) for j in range(ncols)]
    # the RHS column is separated by a vertical bar; a rule separates the
    # objective row from the constraints
    lead = 1 if rownums else 0
    sep_after = ncols - 2  # bar before last column

    def hline() -> str:
        parts = []
        for j in range(ncols):
            parts.append("-" * (widths[j] + 2))
            if j == sep_after or (lead and j == lead - 1):
                parts.append("+")
        return "+" + "+".join(["".join(parts)]) + "+"

    def fmt(row: List[str]) -> str:
        out = "|"
        for j in range(ncols):
            out += f" {row[j]:>{widths[j]}} "
            if j == sep_after or (lead and j == lead - 1):
                out += "|"
        return out + "|"

    lines = [hline()]
    idx = 0
    if labels:
        lines.append(fmt(cells[0]))
        lines.append(hline())
        idx = 1
    lines.append(fmt(cells[idx]))  # objective row
    lines.append(hline())
    for row in cells[idx + 1:]:
        lines.append(fmt(row))
    lines.append(hline())
    return "\n".join(lines)


def render_latex(tab, labels: bool = True, rownums: bool = False) -> str:
    """LaTeX tabular environment."""
    cells = _cells(tab, labels, rownums)
    ncols = len(cells[0])
    colspec = "|" + "r" * (ncols - 1) + "|r|"
    lines = [f"\\begin{{tabular}}{{{colspec}}}", "\\hline"]
    idx = 0
    if labels:
        head = " & ".join(
            c.replace("$", "\\$").replace("_", "\\_") for c in cells[0])
        lines.append(head + " \\\\")
        lines.append("\\hline")
        idx = 1
    for k, row in enumerate(cells[idx:]):
        lines.append(" & ".join(row) + " \\\\")
        if k == 0:
            lines.append("\\hline")
    lines.append("\\hline")
    lines.append("\\end{tabular}")
    return "\n".join(lines)


def render_csv(tab, labels: bool = True, rownums: bool = False) -> str:
    """CSV text (one line per tableau row)."""
    buf = _io.StringIO()
    writer = csv.writer(buf)
    for row in _cells(tab, labels, rownums):
        writer.writerow(row)
    return buf.getvalue()

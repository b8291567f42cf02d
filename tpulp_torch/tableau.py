"""Exact-rational dense simplex tableau (host side).

Capability parity with the reference ``Tableau`` (tableau.py:16-521), with a
different internal design: ONE (m+1) x (n+1) grid of Fractions, with the
objective row on top and the RHS as the last column::

      | c_0  c_1 ... c_{n-1} | -z  |      row 0: reduced costs | negated obj
      | a_00 a_01 ...        | b_0 |      rows 1..m: constraints | RHS
      | ...                  | ... |

This mirrors the device tableau layout (``tpulp.core.state``), so the host
class doubles as the exact oracle for kernel golden tests. Every elementary
row operation acts on full grid rows (RHS included), which makes ``pivot`` a
uniform rank-1 elimination across all rows including the objective.

Differences from the reference (deliberate — SURVEY.md §2.7):
* getters return copies, never live internal lists (reference leaked aliases,
  tableau.py:86-104);
* ``removeRow`` / ``removeRows`` / ``removeCol`` / ``removeCols`` exist as
  first-class operations (the reference's Simplex broke the abstraction with
  direct field surgery and a row-count corruption bug, simplex.py:86-100);
* explicit bounds checking (IndexError) on all indexed accessors.
"""

from __future__ import annotations

import json
from fractions import Fraction
from typing import Any, List, Optional, Sequence, Tuple

from .model.expr import as_fraction

__all__ = ["Tableau"]

ZERO = Fraction(0)
ONE = Fraction(1)


class Tableau:
    """Dense exact-rational simplex tableau (minimization convention).

    ``m`` constraint rows, ``n`` variables. The stored corner value is ``-z``
    (like the reference, tableau.py:82-84,128-130): ``getZ()`` negates on read
    and ``setZ`` on write, so the JSON schema interoperates byte-for-byte.
    """

    __slots__ = ("_grid", "_names", "_marks")

    def __init__(self, m: int, n: int):
        if not isinstance(m, int) or m <= 0:
            raise ValueError(f"need at least 1 constraint row, got {m}")
        if not isinstance(n, int) or n <= 0:
            raise ValueError(f"need at least 1 variable, got {n}")
        self._grid: List[List[Fraction]] = [
            [ZERO] * (n + 1) for _ in range(m + 1)
        ]
        self._names: List[str] = [""] * n
        self._marks: List[bool] = [False] * n

    # -- index validation ----------------------------------------------------

    def _check_row(self, i: int) -> int:
        if not 0 <= i < self.getNumCons():
            raise IndexError(f"row {i} out of range [0, {self.getNumCons()})")
        return i

    def _check_col(self, j: int) -> int:
        if not 0 <= j < self.getNumVars():
            raise IndexError(f"col {j} out of range [0, {self.getNumVars()})")
        return j

    # -- shape / equality ----------------------------------------------------

    def getNumCons(self) -> int:
        return len(self._grid) - 1

    def getNumVars(self) -> int:
        return len(self._grid[0]) - 1

    def getTableauSize(self) -> Tuple[int, int]:
        return (self.getNumCons(), self.getNumVars())

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, Tableau):
            raise TypeError("can only compare Tableau with Tableau")
        return (
            self._grid == other._grid
            and self._names == other._names
            and self._marks == other._marks
        )

    # -- getters (all return copies, never internal aliases) -----------------

    def getZ(self) -> Fraction:
        return -self._grid[0][-1]

    def getC(self) -> List[Fraction]:
        return self._grid[0][:-1]

    def getCj(self, j: int) -> Fraction:
        return self._grid[0][self._check_col(j)]

    def getB(self) -> List[Fraction]:
        return [row[-1] for row in self._grid[1:]]

    def getBi(self, i: int) -> Fraction:
        return self._grid[1 + self._check_row(i)][-1]

    def getA(self) -> List[List[Fraction]]:
        return [row[:-1] for row in self._grid[1:]]

    def getAij(self, i: int, j: int) -> Fraction:
        return self._grid[1 + self._check_row(i)][self._check_col(j)]

    def getVarNames(self) -> List[str]:
        return list(self._names)

    def getVarName(self, j: int) -> str:
        return self._names[self._check_col(j)]

    def getVarMarks(self) -> List[bool]:
        return list(self._marks)

    def getVarMark(self, j: int) -> bool:
        return self._marks[self._check_col(j)]

    # -- setters (coerce through Fraction: int / 'p/q' str / Fraction) -------

    def setZ(self, z: Any) -> None:
        self._grid[0][-1] = -as_fraction(z)

    def setC(self, c: Sequence[Any]) -> None:
        n = self.getNumVars()
        if len(c) != n:
            raise ValueError(f"expected {n} costs, got {len(c)}")
        for j in range(n):
            self._grid[0][j] = as_fraction(c[j])

    def setCj(self, j: int, cj: Any) -> None:
        self._grid[0][self._check_col(j)] = as_fraction(cj)

    def setB(self, b: Sequence[Any]) -> None:
        m = self.getNumCons()
        if len(b) != m:
            raise ValueError(f"expected {m} RHS values, got {len(b)}")
        for i in range(m):
            self._grid[1 + i][-1] = as_fraction(b[i])

    def setBi(self, i: int, bi: Any) -> None:
        self._grid[1 + self._check_row(i)][-1] = as_fraction(bi)

    def setA(self, a: Sequence[Sequence[Any]]) -> None:
        m, n = self.getTableauSize()
        if len(a) != m:
            raise ValueError(f"expected {m} rows, got {len(a)}")
        for i in range(m):
            if len(a[i]) != n:
                raise ValueError(f"row {i}: expected {n} entries, got {len(a[i])}")
            for j in range(n):
                self._grid[1 + i][j] = as_fraction(a[i][j])

    def setAij(self, i: int, j: int, aij: Any) -> None:
        self._grid[1 + self._check_row(i)][self._check_col(j)] = as_fraction(aij)

    def setVarNames(self, names: Sequence[str]) -> None:
        n = self.getNumVars()
        if len(names) != n:
            raise ValueError(f"expected {n} names, got {len(names)}")
        self._names = [str(x) for x in names]

    def setVarName(self, j: int, name: str) -> None:
        self._names[self._check_col(j)] = str(name)

    def setVarMarks(self, marks: Sequence[bool]) -> None:
        n = self.getNumVars()
        if len(marks) != n:
            raise ValueError(f"expected {n} marks, got {len(marks)}")
        self._marks = [bool(x) for x in marks]

    def setVarMark(self, j: int, mark: bool) -> None:
        self._marks[self._check_col(j)] = bool(mark)

    def toggleVarMark(self, j: int) -> None:
        j = self._check_col(j)
        self._marks[j] = not self._marks[j]

    # -- shape edits ---------------------------------------------------------

    def addVar(self, name: str = "") -> None:
        for row in self._grid:
            row.insert(-1, ZERO)
        self._names.append(str(name))
        self._marks.append(False)

    def addVars(self, names: Sequence[str]) -> None:
        for name in names:
            self.addVar(name)

    def addCon(self) -> None:
        self._grid.append([ZERO] * (self.getNumVars() + 1))

    def addCons(self, count: int) -> None:
        if count < 0:
            raise ValueError("count must be nonnegative")
        for _ in range(count):
            self.addCon()

    def removeRow(self, i: int) -> None:
        """Delete constraint row ``i`` (the op the reference lacked,
        forcing field surgery at simplex.py:86-100)."""
        self._check_row(i)
        if self.getNumCons() == 1:
            raise ValueError("cannot remove the last constraint row")
        del self._grid[1 + i]

    def removeRows(self, rows: Sequence[int]) -> None:
        for i in sorted(set(rows), reverse=True):
            self.removeRow(i)

    def removeCol(self, j: int) -> None:
        """Delete variable column ``j``."""
        self._check_col(j)
        if self.getNumVars() == 1:
            raise ValueError("cannot remove the last variable column")
        for row in self._grid:
            del row[j]
        del self._names[j]
        del self._marks[j]

    def removeCols(self, cols: Sequence[int]) -> None:
        for j in sorted(set(cols), reverse=True):
            self.removeCol(j)

    def truncateVars(self, n: int) -> None:
        """Keep only the first ``n`` variable columns."""
        if not 0 < n <= self.getNumVars():
            raise ValueError(f"cannot truncate to {n} vars")
        self.removeCols(range(n, self.getNumVars()))

    def permuteRows(self, perm: Sequence[int]) -> None:
        m = self.getNumCons()
        if sorted(perm) != list(range(m)):
            raise ValueError(f"not a permutation of 0..{m - 1}: {list(perm)}")
        body = self._grid[1:]
        self._grid[1:] = [body[perm[i]] for i in range(m)]

    def permuteCols(self, perm: Sequence[int]) -> None:
        n = self.getNumVars()
        if sorted(perm) != list(range(n)):
            raise ValueError(f"not a permutation of 0..{n - 1}: {list(perm)}")
        for row in self._grid:
            row[:-1] = [row[perm[j]] for j in range(n)]
        self._names = [self._names[perm[j]] for j in range(n)]
        self._marks = [self._marks[perm[j]] for j in range(n)]

    def copy(self) -> "Tableau":
        out = Tableau(*self.getTableauSize())
        out._grid = [list(row) for row in self._grid]
        out._names = list(self._names)
        out._marks = list(self._marks)
        return out

    # -- elementary row operations (full rows, RHS included) -----------------
    # Row index r refers to constraint row r; the objective row is addressed
    # by the *AddToObj/*SubFromObj variants (same contract as the reference).

    def rowMult(self, r: int, mult: Any) -> None:
        mult = as_fraction(mult)
        if mult == 1:
            return
        row = self._grid[1 + self._check_row(r)]
        for k in range(len(row)):
            row[k] *= mult

    def rowDiv(self, r: int, div: Any) -> None:
        div = as_fraction(div)
        if div == 0:
            raise ZeroDivisionError("row division by zero")
        self.rowMult(r, ONE / div)

    def rowAdd(self, rd: int, rs: int, mult: Any = ONE) -> None:
        mult = as_fraction(mult)
        if mult == 0:
            return
        dst = self._grid[1 + self._check_row(rd)]
        src = self._grid[1 + self._check_row(rs)]
        for k in range(len(dst)):
            dst[k] += mult * src[k]

    def rowSub(self, rd: int, rs: int, mult: Any = ONE) -> None:
        self.rowAdd(rd, rs, -as_fraction(mult))

    def rowAddToObj(self, r: int, mult: Any = ONE) -> None:
        """obj_row += mult * row r — including the corner, so the stored -z
        picks up mult*b_r automatically (one uniform row op; the reference
        needed a special case at tableau.py:282-289)."""
        mult = as_fraction(mult)
        if mult == 0:
            return
        dst = self._grid[0]
        src = self._grid[1 + self._check_row(r)]
        for k in range(len(dst)):
            dst[k] += mult * src[k]

    def rowSubFromObj(self, r: int, mult: Any = ONE) -> None:
        self.rowAddToObj(r, -as_fraction(mult))

    # -- the pivot -----------------------------------------------------------

    def pivot(self, r: int, c: int) -> None:
        """Gauss-Jordan pivot on (row r, col c): normalize the pivot row and
        eliminate column c from every other row INCLUDING the objective row.
        Assumes nothing about canonical form. Raises ZeroDivisionError if the
        pivot element is zero. (Reference: tableau.py:295-308.)"""
        r = self._check_row(r)
        c = self._check_col(c)
        piv = self._grid[1 + r][c]
        if piv == 0:
            raise ZeroDivisionError(f"zero pivot at ({r}, {c})")
        prow = self._grid[1 + r]
        if piv != 1:
            inv = ONE / piv
            for k in range(len(prow)):
                prow[k] *= inv
        for idx, row in enumerate(self._grid):
            if idx == 1 + r:
                continue
            factor = row[c]
            if factor == 0:
                continue
            for k in range(len(row)):
                row[k] -= factor * prow[k]
        return None

    # -- serialization (JSON schema interoperable with the reference,
    #    tableau.py:322-360: z field stores the RAW corner value -z) ---------

    def saveJson(self) -> dict:
        m, n = self.getTableauSize()
        return {
            "m": m,
            "n": n,
            "z": str(self._grid[0][-1]),
            "c": [str(v) for v in self._grid[0][:-1]],
            "b": [str(row[-1]) for row in self._grid[1:]],
            "a": [[str(v) for v in row[:-1]] for row in self._grid[1:]],
            "cl": list(self._names),
            "cm": list(self._marks),
        }

    def loadJson(self, data: dict) -> None:
        m = data["m"]
        n = data["n"]
        if not (isinstance(m, int) and m > 0 and isinstance(n, int) and n > 0):
            raise ValueError(f"bad tableau dimensions m={m!r} n={n!r}")
        grid = [[ZERO] * (n + 1) for _ in range(m + 1)]
        grid[0][-1] = as_fraction(data["z"])
        for j in range(n):
            grid[0][j] = as_fraction(data["c"][j])
        for i in range(m):
            grid[1 + i][-1] = as_fraction(data["b"][i])
            for j in range(n):
                grid[1 + i][j] = as_fraction(data["a"][i][j])
        self._grid = grid
        self._names = [str(x) for x in data["cl"]]
        self._marks = [bool(x) for x in data["cm"]]

    def saveFile(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.saveJson(), fh)

    def loadFile(self, path: str) -> None:
        with open(path) as fh:
            self.loadJson(json.load(fh))

    # -- conversion to/from arrays (bridge to the device path) ---------------

    @classmethod
    def fromArrays(cls, c, a, b, z: Any = 0, names: Optional[Sequence[str]] = None) -> "Tableau":
        """Build from (cost vector, matrix, rhs) of Fraction-coercibles."""
        m = len(a)
        n = len(c)
        tab = cls(m, n)
        tab.setC(list(c))
        tab.setA([list(row) for row in a])
        tab.setB(list(b))
        tab.setZ(z)
        if names is not None:
            tab.setVarNames(list(names))
        else:
            tab.setVarNames([f"x{j}" for j in range(n)])
        return tab

    def toGrid(self) -> List[List[Fraction]]:
        """The full (m+1) x (n+1) grid, objective row first, RHS last column.
        Matches the device tableau layout exactly."""
        return [list(row) for row in self._grid]

    # -- rendering (see tpulp.io.render for the implementations) -------------

    def printGrid(self, labels: bool = True, rownums: bool = True) -> List[List[str]]:
        from .io.render import render_grid

        return render_grid(self, labels=labels, rownums=rownums)

    def printText(self, labels: bool = True, rownums: bool = False) -> str:
        from .io.render import render_text

        return render_text(self, labels=labels, rownums=rownums)

    def printLatex(self, labels: bool = True, rownums: bool = False) -> str:
        from .io.render import render_latex

        return render_latex(self, labels=labels, rownums=rownums)

    def printCSV(self, labels: bool = True, rownums: bool = False) -> str:
        from .io.render import render_csv

        return render_csv(self, labels=labels, rownums=rownums)

    def __str__(self) -> str:
        return self.printText()

    def __repr__(self) -> str:
        m, n = self.getTableauSize()
        return f"<Tableau {m}x{n} z={self.getZ()}>"

    # -- form predicates -----------------------------------------------------

    def isCanonical(self, bcols: Optional[List[int]] = None) -> bool:
        """True iff all b >= 0 and every row has a basic (unit) column with a
        zero reduced cost. If ``bcols`` is given it receives, per row, the
        basic column index (or -1); filled even on failure, like the
        reference (tableau.py:466-496)."""
        m, n = self.getTableauSize()
        if bcols is not None:
            bcols[:] = [-1] * m
        ok = True
        for i in range(m):
            if self.getBi(i) < 0:
                ok = False
        # candidate basic columns: zero reduced cost, exactly one nonzero
        # entry (== 1) in constraint rows
        for i in range(m):
            found = -1
            for j in range(n):
                if self._grid[0][j] != 0:
                    continue
                col_ok = True
                for ii in range(m):
                    want = ONE if ii == i else ZERO
                    if self._grid[1 + ii][j] != want:
                        col_ok = False
                        break
                if col_ok:
                    found = j
                    break
            if bcols is not None:
                bcols[i] = found
            if found < 0:
                ok = False
        return ok

    def isOptimal(self) -> bool:
        """All reduced costs nonnegative (assumes canonical form)."""
        return all(v >= 0 for v in self._grid[0][:-1])

    def isUnbounded(self) -> bool:
        """Some improving column has no positive entry (assumes canonical)."""
        m, n = self.getTableauSize()
        for j in range(n):
            if self._grid[0][j] < 0:
                if all(self._grid[1 + i][j] <= 0 for i in range(m)):
                    return True
        return False

    def isInfeasible(self) -> bool:
        """Some row has b > 0 but no positive coefficient (assumes canonical
        ... of a phase-1-style tableau)."""
        m, n = self.getTableauSize()
        for i in range(m):
            if self._grid[1 + i][-1] > 0:
                if all(self._grid[1 + i][j] <= 0 for j in range(n)):
                    return True
        return False

    def isDegenerate(self) -> bool:
        """Some basic variable is at zero (b_i == 0)."""
        return any(row[-1] == 0 for row in self._grid[1:])

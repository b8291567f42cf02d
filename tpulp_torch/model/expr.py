"""Linear expressions over named variables, with exact rational coefficients.

Capability parity with the reference modeling layer (``linprog.py:22-222`` in
tkoz0/linear-program-solver): sparse dict of var -> coefficient plus a constant
term, operator algebra, constraint builders, evaluate/substitute. Differences
from the reference (deliberate, see SURVEY.md §2.7):

* scalar multiplication/division are implemented (``__mul__``/``__truediv__``),
  which the reference lacks;
* ``constraintEq`` is the primary name; the reference's misspelled
  ``constrantEq`` (linprog.py:180) is kept as a compatibility alias.
"""

from __future__ import annotations

import numbers
import re
from fractions import Fraction
from typing import Any, Dict, Mapping, Union

__all__ = ["LinExpr", "VARNAME_RE", "as_fraction"]

# Legal variable names: python-identifier-like (reference: linprog.py:20).
VARNAME_RE = re.compile(r"[_A-Za-z][_A-Za-z0-9]*")

Scalar = Union[int, str, float, Fraction]


def as_fraction(value: Any) -> Fraction:
    """Coerce ints, 'p/q' strings, floats and Fractions to an exact Fraction."""
    if isinstance(value, Fraction):
        return value
    return Fraction(value)


def _check_varname(name: Any) -> str:
    if not isinstance(name, str):
        raise TypeError(f"variable name must be str, got {type(name).__name__}")
    if not VARNAME_RE.fullmatch(name):
        raise ValueError(f"invalid var name: {name!r}")
    return name


class LinExpr:
    """A linear expression ``sum_i c_i * x_i + const``.

    Stored sparsely as ``{varname: coefficient}`` with exact ``Fraction``
    coefficients; zero coefficients are dropped eagerly so two equal
    expressions always have identical term dicts.

    Constructor takes the flat vararg form ``LinExpr(c1, x1, c2, x2, ..., k)``
    meaning ``c1*x1 + c2*x2 + ... + k``; the trailing constant is optional.
    Coefficients accept anything ``Fraction`` accepts (int, 'p/q' str, ...).
    """

    __slots__ = ("_terms", "_const")

    def __init__(self, *args: Any):
        self._terms: Dict[str, Fraction] = {}
        self._const: Fraction = Fraction(0)
        n = len(args)
        i = 0
        while i < n:
            if i == n - 1:
                # odd arg count: trailing constant
                self._const = as_fraction(args[i])
                break
            self._add_term(_check_varname(args[i + 1]), as_fraction(args[i]))
            i += 2

    # -- internal helpers ---------------------------------------------------

    def _add_term(self, name: str, coeff: Fraction) -> None:
        new = self._terms.get(name, Fraction(0)) + coeff
        if new == 0:
            self._terms.pop(name, None)
        else:
            self._terms[name] = new

    def _merge(self, other: Any, sign: int) -> "LinExpr":
        """In-place ``self += sign*other`` for scalar or LinExpr operands."""
        if isinstance(other, LinExpr):
            for name, coeff in other._terms.items():
                self._add_term(name, sign * coeff)
            self._const += sign * other._const
        else:
            self._const += sign * as_fraction(other)
        return self

    # -- accessors ----------------------------------------------------------

    def getConstant(self) -> Fraction:
        """The constant term."""
        return self._const

    def getCoefficient(self, x: str) -> Fraction:
        """Coefficient of variable ``x`` (0 if absent)."""
        return self._terms.get(x, Fraction(0))

    def variables(self) -> tuple:
        """Sorted tuple of variable names with nonzero coefficients."""
        return tuple(sorted(self._terms))

    def terms(self) -> Dict[str, Fraction]:
        """A *copy* of the {var: coeff} mapping (no internal aliasing)."""
        return dict(self._terms)

    def isConstant(self) -> bool:
        return not self._terms

    def copy(self) -> "LinExpr":
        out = LinExpr()
        out._terms = dict(self._terms)
        out._const = self._const
        return out

    # -- comparison ---------------------------------------------------------

    def __eq__(self, other: Any) -> bool:
        if isinstance(other, LinExpr):
            return self._terms == other._terms and self._const == other._const
        if isinstance(other, (int, str, Fraction, numbers.Rational)):
            # equal to a scalar iff no variable terms and constants match
            return not self._terms and self._const == as_fraction(other)
        return NotImplemented

    def __hash__(self) -> int:  # usable as dict key once built
        return hash((frozenset(self._terms.items()), self._const))

    # -- rendering ----------------------------------------------------------

    def __str__(self) -> str:
        parts = []
        for name in sorted(self._terms):
            coeff = self._terms[name]
            if not parts:
                if coeff == 1:
                    parts.append(name)
                elif coeff == -1:
                    parts.append(f"-{name}")
                else:
                    parts.append(f"{coeff}*{name}")
            else:
                op = "+" if coeff > 0 else "-"
                mag = abs(coeff)
                term = name if mag == 1 else f"{mag}*{name}"
                parts.append(f"{op} {term}")
        if self._const != 0 or not parts:
            if not parts:
                parts.append(str(self._const))
            else:
                op = "+" if self._const > 0 else "-"
                parts.append(f"{op} {abs(self._const)}")
        return " ".join(parts)

    def __repr__(self) -> str:
        args = []
        for name in sorted(self._terms):
            args.append(repr(str(self._terms[name])))
            args.append(repr(name))
        if self._const != 0 or not args:
            args.append(repr(str(self._const)))
        return f"LinExpr({', '.join(args)})"

    # -- algebra ------------------------------------------------------------

    def __iadd__(self, other: Any) -> "LinExpr":
        return self._merge(other, +1)

    def __isub__(self, other: Any) -> "LinExpr":
        return self._merge(other, -1)

    def __neg__(self) -> "LinExpr":
        out = LinExpr()
        out._terms = {k: -v for k, v in self._terms.items()}
        out._const = -self._const
        return out

    def __pos__(self) -> "LinExpr":
        return self.copy()

    def __add__(self, other: Any) -> "LinExpr":
        return self.copy()._merge(other, +1)

    def __radd__(self, other: Any) -> "LinExpr":
        return self.copy()._merge(other, +1)

    def __sub__(self, other: Any) -> "LinExpr":
        return self.copy()._merge(other, -1)

    def __rsub__(self, other: Any) -> "LinExpr":
        return (-self)._merge(other, +1)

    def __mul__(self, scalar: Any) -> "LinExpr":
        # extension over the reference: scalar multiplication
        s = as_fraction(scalar)
        out = LinExpr()
        if s != 0:
            out._terms = {k: v * s for k, v in self._terms.items()}
        out._const = self._const * s
        return out

    __rmul__ = __mul__

    def __truediv__(self, scalar: Any) -> "LinExpr":
        s = as_fraction(scalar)
        return self * (Fraction(1) / s)

    # -- constraint builders -------------------------------------------------

    def constraintEq(self, other: Any) -> "LinCon":
        from .con import LinCon

        return LinCon(self.copy(), "==", other)

    def constraintLeq(self, other: Any) -> "LinCon":
        from .con import LinCon

        return LinCon(self.copy(), "<=", other)

    def constraintGeq(self, other: Any) -> "LinCon":
        from .con import LinCon

        return LinCon(self.copy(), ">=", other)

    # reference-API compatibility alias (typo at linprog.py:180)
    constrantEq = constraintEq

    # -- evaluation / substitution ------------------------------------------

    def evaluate(self, assignment: Mapping[str, Any]) -> Fraction:
        """Value of the expression under a full variable assignment."""
        total = self._const
        for name, coeff in self._terms.items():
            total += coeff * as_fraction(assignment[name])
        return total

    def substitute(self, mapping: Mapping[str, Any]) -> "LinExpr":
        """Replace variables by scalars or expressions; unmapped vars remain.

        The workhorse for standard-form lowering (bound shifts x -> x' + lb,
        free-variable splits x -> xp - xn).
        """
        out = LinExpr()
        out._const = self._const
        for name, coeff in self._terms.items():
            if name in mapping:
                repl = mapping[name]
                if isinstance(repl, LinExpr):
                    out._merge(repl * coeff, +1)
                else:
                    out._const += coeff * as_fraction(repl)
            else:
                out._add_term(name, coeff)
        return out

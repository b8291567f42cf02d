"""Numerical equilibration (scaling) of a StandardForm before device solving.

The reference solver never needed scaling because every pivot is exact
rational arithmetic (the reference's lpsol/tableau.py:295-308). The float
device substitute does: measured on TPU, dense ill-scaled systems lose
phase-1 fidelity (BENCH.md scale probe — f64 phase 1 falsely reporting
infeasible), and every production LP code answers with a geometric-mean /
Curtis-Reid-style row-column equilibration pass. This module is that pass,
designed for the exact-ladder architecture:

* **Scale factors are powers of two.** Multiplying a float by 2**k is
  EXACT in binary floating point, so the device sees a genuinely
  re-conditioned matrix with zero additional rounding; and as ``Fraction``
  factors they keep the scaled rational data small (denominator growth is
  a single power of two).
* **Only the device iteration sees scaled data.** Scaling maps
  ``A' = R A S,  b' = R b,  c' = S c`` with ``R = diag(2**rp_i)``,
  ``S = diag(2**cp_j)`` and ``x = S x'``. A basis is feasible/optimal for
  the scaled problem iff it is for the original, and the scaled
  minimization objective value EQUALS the original (``c'.x' = c.x``), so
  the final basis from the scaled device walk is refined, certified, and
  priced (duals) against the ORIGINAL StandardForm — the exactness
  contract of the ladder is untouched, and the final basis needs no
  mapping at all.
* ``b >= 0`` and ``x >= 0`` are preserved (all factors positive);
  ``basis_hint`` slack columns are pinned to scale exactly back to unit
  (``make_state`` treats them as ready identity columns); ``upper`` spans
  scale by ``2**-cp_j`` (the bounded-variable lowering composes).

The power computation is a vectorized numpy pass over the (cached) dense
matrix; the exact Fraction scaling is cached per underlying (A, c) list
object for the same reason ``StandardForm.to_dense`` is — B&B nodes are
``replace(root, b=...)`` clones sharing the root's A/c, so a wave
equilibrates the matrix once and per-node work is one b-vector scale.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .lower import StandardForm

__all__ = ["equilibrate_standard_form", "equilibration_powers_dense",
           "is_material_scaling", "scaled_dense"]

# cache: (id(A), id(c)) -> (A_ref, c_ref, row_pows, col_pows, A', c', upper')
_EQUIL_CACHE: dict = {}


def equilibration_powers_dense(
    A: np.ndarray,
    rounds: int = 4,
    basis_hint: Optional[Sequence[int]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Geometric-mean row/column equilibration powers (of 2) for dense ``A``.

    Alternating passes: each row (then column) is scaled by the power of two
    nearest ``-mean(log2|entry|)`` over its nonzeros; converges in a few
    rounds (each pass leaves geometric means within [1/sqrt(2), sqrt(2))).
    Zero (or non-finite) entries are ignored; empty rows/columns keep
    power 0. When ``basis_hint`` is given, each hinted slack column's power
    is pinned to ``-row_power`` of its row so the scaled entry is exactly 1
    (``make_state`` relies on hinted columns being exact unit columns; a
    slack has a single nonzero, so the pin costs nothing in conditioning).
    """
    A = np.asarray(A, dtype=np.float64)
    m, n = A.shape
    with np.errstate(divide="ignore", invalid="ignore"):
        L = np.log2(np.abs(A))
    mask = np.isfinite(L)
    L = np.where(mask, L, 0.0)
    rcnt = mask.sum(axis=1)
    ccnt = mask.sum(axis=0)
    rp = np.zeros(m)
    cp = np.zeros(n)
    for _ in range(rounds):
        tot = L + rp[:, None] + cp[None, :]
        rstep = -np.round(
            np.where(rcnt > 0, (tot * mask).sum(axis=1) / np.maximum(rcnt, 1),
                     0.0))
        rp += rstep
        tot = L + rp[:, None] + cp[None, :]
        cstep = -np.round(
            np.where(ccnt > 0, (tot * mask).sum(axis=0) / np.maximum(ccnt, 1),
                     0.0))
        cp += cstep
        if not (rstep.any() or cstep.any()):
            break
    rp = rp.astype(np.int64)
    cp = cp.astype(np.int64)
    if basis_hint is not None:
        for i, h in enumerate(basis_hint):
            if h >= 0:
                cp[h] = -rp[i]
    return rp, cp


def is_material_scaling(row_pows, col_pows, threshold: int = 3) -> bool:
    """Whether the computed scaling is worth applying.

    Balanced data (entries O(1)) produces powers in {-2..2} (the
    geometric mean of |N(0,1)| is ~0.53, so unit-scale rows legitimately
    round to power 1-2); applying those changes pivot walks for no
    conditioning gain. ``threshold=3`` (any factor >= 8x away from unit)
    is the default gate used by ``solve_standard_form(scale='auto')``.
    """
    return bool(np.max(np.abs(np.asarray(row_pows)), initial=0) >= threshold
                or np.max(np.abs(np.asarray(col_pows)), initial=0)
                >= threshold)


def scaled_dense(
    c: np.ndarray, A: np.ndarray, b: np.ndarray,
    row_pows: np.ndarray, col_pows: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Apply power-of-two scaling to dense float data — EXACT in binary fp
    (barring exponent over/underflow, which material powers never reach for
    data that was finite to begin with)."""
    R = np.ldexp(1.0, row_pows.astype(np.int32))
    C = np.ldexp(1.0, col_pows.astype(np.int32))
    return c * C, A * R[:, None] * C[None, :], b * R


def _pow2(p: int) -> Fraction:
    return Fraction(2) ** int(p)


def equilibrate_standard_form(
    sf: StandardForm, rounds: int = 4
) -> Tuple[StandardForm, List[int], List[int]]:
    """Scaled exact-rational clone of ``sf`` plus the (row, col) powers.

    See module doc for the mapping. The scaled form shares NO A/c lists
    with the input (so ``to_dense`` caches don't collide) but IS cached per
    input (A, c) identity: B&B node clones reuse the matrix scaling and
    only re-scale their ``b``. Solutions map back as
    ``x_j = 2**col_pows[j] * x'_j``; the minimization objective value is
    invariant; the basis needs no mapping at all.
    """
    key = (id(sf.A), id(sf.c))
    ent = _EQUIL_CACHE.get(key)
    if ent is None or ent[0] is not sf.A or ent[1] is not sf.c:
        _, Ad, _ = sf.to_dense(np.float64)
        rp, cp = equilibration_powers_dense(Ad, rounds=rounds,
                                            basis_hint=sf.basis_hint)
        csc = [_pow2(p) for p in cp]
        A2 = [
            [v * csc[j] * rs if v else v for j, v in enumerate(row)]
            for row, rs in zip(sf.A, (_pow2(p) for p in rp))
        ]
        c2 = [v * csc[j] for j, v in enumerate(sf.c)]
        upper2 = None
        if sf.upper is not None:
            upper2 = [None if u is None else u / csc[j]
                      for j, u in enumerate(sf.upper)]
        if len(_EQUIL_CACHE) >= 8:
            _EQUIL_CACHE.clear()
        _EQUIL_CACHE[key] = ent = (sf.A, sf.c, rp, cp, A2, c2, upper2)
    _, _, rp, cp, A2, c2, upper2 = ent
    b2 = [v * _pow2(p) for v, p in zip(sf.b, rp)]
    scaled = dataclasses.replace(sf, A=A2, c=c2, b=b2, upper=upper2)
    return scaled, [int(p) for p in rp], [int(p) for p in cp]

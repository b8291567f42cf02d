"""Checkpoint and resume: solver states and branch-and-bound frontiers.

The counterpart of ``tpulp.io.checkpoint``, which imports jax through its
state module. ``save_state`` / ``load_state`` keep a ``SimplexState`` in an
``.npz`` archive with tpulp's field names and dtypes. The frontier format
is tpulp's JSON, unchanged: every rational is an exact 'p/q' string, and
parent bases are in the batched column space that both packages build the
same way, so a checkpoint written by either package resumes in the other.
"""

from __future__ import annotations

import json
from fractions import Fraction
from typing import Any, Dict, List, Tuple

import numpy as np

from ..core.state import SimplexState, from_numpy_state, to_numpy_state

__all__ = [
    "save_state",
    "load_state",
    "save_bnb_frontier",
    "load_bnb_frontier",
]


def save_state(path: str, state: SimplexState) -> None:
    """Write a SimplexState to ``path`` (.npz)."""
    np.savez(path, **dict(zip(SimplexState._fields, to_numpy_state(state))))


def load_state(path: str, dtype=None, device="cuda") -> SimplexState:
    """Read a SimplexState onto ``device``; ``dtype`` optionally casts the
    tableau (and ``last_z``)."""
    with np.load(path) as data:
        leaves = [data[name] for name in SimplexState._fields]
    return from_numpy_state(leaves, device=device, dtype=dtype)


def save_bnb_frontier(path: str, frontier: List[Tuple], incumbent_z,
                      meta: Dict[str, Any] | None = None) -> None:
    """Persist a B&B frontier:
    [(bound, tiebreak, {var: (lb, ub)}, parent_basis|None), ...].

    The optional parent basis (batched-space column indices) lets the
    resumed run warm-start from it; 3-tuples (no basis) resume cold."""
    nodes = []
    for entry in frontier:
        if len(entry) == 3:
            bound, tb, bounds = entry
            pbasis = None
        else:
            bound, tb, bounds, pbasis = entry
        nodes.append({
            "bound": str(bound),
            "tiebreak": tb,
            "bounds": {name: [str(lo), str(hi)]
                       for name, (lo, hi) in bounds.items()},
            "basis": None if pbasis is None else [int(j) for j in pbasis],
        })
    payload = {
        "incumbent_z": None if incumbent_z is None else str(incumbent_z),
        "meta": meta or {},
        "nodes": nodes,
    }
    with open(path, "w") as fh:
        json.dump(payload, fh)


def load_bnb_frontier(path: str):
    """(frontier, incumbent_z, meta) from a saved B&B checkpoint; frontier
    entries are (bound, tiebreak, bounds, parent_basis|None)."""
    with open(path) as fh:
        payload = json.load(fh)
    inc = payload["incumbent_z"]
    incumbent_z = None if inc is None else Fraction(inc)
    frontier = [
        (
            Fraction(node["bound"]),
            node["tiebreak"],
            {name: (Fraction(lo), Fraction(hi))
             for name, (lo, hi) in node["bounds"].items()},
            None if node.get("basis") is None
            else np.asarray(node["basis"], dtype=np.int32),
        )
        for node in payload["nodes"]
    ]
    return frontier, incumbent_z, payload.get("meta", {})

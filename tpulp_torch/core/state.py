"""Tableau state and solver options, on torch tensors.

The PyTorch counterpart of ``tpulp.core.state``. The layout is the same:
one dense tableau ``T`` of shape ``(m + 2, n + 1)`` carries both objective
rows and the constraints,

    row 0   : phase-2 (real) reduced costs | -z2
    row 1   : phase-1 (artificial) costs   | -z1
    row 2+i : A[i, :]                      | b[i]

so the two-phase method needs no tableau surgery: phase 2 switches the
pricing row and masks the artificial columns.

``Status`` and ``SolverOptions`` are copies of tpulp's, not imports: the
JAX package's state module imports jax, and this package never does. The
codes, fields and ``for_dtype`` tolerances are the same, so results of the
two packages compare directly.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "Status",
    "SolverOptions",
    "SimplexState",
    "make_state",
    "from_numpy_state",
    "to_numpy_state",
    "eta_scaled_options",
    "RULE_DANTZIG",
    "RULE_BLAND",
    "RULE_MAX_INCREASE",
    "RULE_DEVEX",
    "TIE_FIRST",
    "TIE_MAXPIV",
]

RULE_DANTZIG = 0
RULE_BLAND = 1
# greatest-improvement pricing: one full-tableau scan per pivot
RULE_MAX_INCREASE = 2
# devex reference-framework pricing (argmax c_j^2 / gamma_j)
RULE_DEVEX = 3
# ratio-test tie resolution (SolverOptions.tie_break)
TIE_FIRST = 0
TIE_MAXPIV = 1


class Status:
    """Solver status codes (int32 on the device)."""

    RUNNING = 0
    OPTIMAL = 1
    UNBOUNDED = 2
    INFEASIBLE = 3
    ITERATION_LIMIT = 4
    # non-finite value in the iterates: the basis is untrustworthy and the
    # caller retries at higher precision
    NUMERIC = 5

    NAMES = {
        0: "running",
        1: "optimal",
        2: "unbounded",
        3: "infeasible",
        4: "iteration_limit",
        5: "numerical_error",
    }


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Static solver configuration; the same fields as tpulp's."""

    rule: int = RULE_DANTZIG
    max_iters: int = 10_000
    # reduced-cost optimality tolerance
    opt_tol: float = 1e-9
    # pivot-element positivity tolerance of the ratio test
    piv_tol: float = 1e-9
    # |z - last_z| at or below this counts as a stalled pivot
    degen_tol: float = 0.0
    # consecutive stalled pivots before the permanent switch to Bland;
    # 0 means m + n
    stall_limit: int = 0
    # phase-1 optimum above this is reported infeasible
    infeas_tol: float = 1e-7
    # basic values above -feas_tol count as primal feasible
    feas_tol: float = 1e-9
    # TIE_FIRST: first min-ratio row; TIE_MAXPIV: the tie row with the
    # largest pivot element (the refreshed rung's growth bound)
    tie_break: int = TIE_FIRST

    def resolved_stall_limit(self, m: int, n: int) -> int:
        return self.stall_limit if self.stall_limit > 0 else m + n

    @classmethod
    def for_dtype(cls, dtype, **overrides) -> "SolverOptions":
        """Defaults scaled to the iterate precision (f32 eps ~1.2e-7)."""
        if _torch_dtype(dtype) == torch.float32:
            base = dict(opt_tol=1e-5, piv_tol=1e-5, infeas_tol=1e-4,
                        feas_tol=1e-5)
        else:
            base = dict(opt_tol=1e-9, piv_tol=1e-9, infeas_tol=1e-7,
                        feas_tol=1e-9)
        base.update(overrides)
        return cls(**base)


class SimplexState(NamedTuple):
    """The per-problem solver state, every field a tensor on one device."""

    T: torch.Tensor           # (m + 2, n + 1) tableau
    basis: torch.Tensor       # (m,) int32: basic column per constraint row
    col_active: torch.Tensor  # (n,) bool: columns available for pricing
    art_cols: torch.Tensor    # (n,) bool: artificial columns
    phase: torch.Tensor       # () int32: 1 or 2
    status: torch.Tensor      # () int32: Status.*
    niter: torch.Tensor       # () int32: pivots performed
    stuck: torch.Tensor       # () int32: consecutive non-improving pivots
    bland: torch.Tensor       # () bool: permanently on Bland's rule
    last_z: torch.Tensor      # () objective after the last pricing pivot

    @property
    def m(self) -> int:
        return self.T.shape[0] - 2

    @property
    def n(self) -> int:
        return self.T.shape[1] - 1

    def objective(self) -> torch.Tensor:
        """Current phase-2 objective value (minimization)."""
        return -self.T[0, -1]


def _torch_dtype(dtype) -> torch.dtype:
    """``torch.float32``/``torch.float64`` from a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name
    if name == "float32":
        return torch.float32
    if name == "float64":
        return torch.float64
    raise ValueError(f"unsupported iterate dtype {dtype!r}")


def canonical_dtype(dtype) -> torch.dtype:
    """The torch dtype the port iterates in for ``dtype`` (tpulp's resolves
    JAX's float64-to-float32 truncation; torch keeps float64)."""
    return _torch_dtype(dtype)


# rank-K engines rebuild the entering column from up to K etas; at f32 that
# reconstruction carries ~1e-4 relative noise, so their ratio test needs
# this pivot tolerance (the same floor as tpulp's)
ETA_F32_PIV_TOL = 1e-4


def eta_scaled_options(opts: SolverOptions, dtype) -> SolverOptions:
    """Ratio-test tolerance for the rank-K (eta-reconstruction) engines:
    f32 iterates get ``piv_tol >= 1e-4``; f64, or a caller's looser
    tolerance, is left as it is."""
    if _torch_dtype(dtype) != torch.float32:
        return opts
    if opts.piv_tol >= ETA_F32_PIV_TOL:
        return opts
    return dataclasses.replace(opts, piv_tol=ETA_F32_PIV_TOL)


def _numpy_state(c, A, b, basis_hint, n_extra_art: int):
    """(T, basis, col_active, art_cols, phase) in numpy, as tpulp builds
    them."""
    c = np.asarray(c, dtype=np.float64)
    A = np.asarray(A, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    m, n0 = A.shape
    hint = list(basis_hint)
    art_rows = [i for i in range(m) if hint[i] < 0]
    n_art = len(art_rows) + int(n_extra_art)
    n = n0 + n_art

    T = np.zeros((m + 2, n + 1), dtype=np.float64)
    T[0, :n0] = c
    T[2:, :n0] = A
    T[2:, -1] = b

    basis = np.zeros((m,), dtype=np.int32)
    art_mask = np.zeros((n,), dtype=bool)
    art_mask[n0:] = True
    for k, i in enumerate(art_rows):
        j = n0 + k
        T[2 + i, j] = 1.0
        basis[i] = j
    for i in range(m):
        if hint[i] >= 0:
            basis[i] = hint[i]

    if art_rows:
        # phase-1 objective pre-reduced over the initial basis
        T[1, :] = -T[2:, :][np.array(art_rows)].sum(axis=0)
        T[1, n0: n0 + len(art_rows)] = 0.0
        phase = 1
    else:
        phase = 2

    col_active = np.ones((n,), dtype=bool)
    col_active[n0 + len(art_rows):] = False  # padded artificials
    if phase == 2:
        col_active &= ~art_mask
    return T, basis, col_active, art_mask, phase


def make_state(c, A, b, basis_hint, dtype=torch.float64,
               n_extra_art: int = 0, device="cuda") -> SimplexState:
    """Build the initial state from standard-form arrays on ``device``.

    ``basis_hint[i] >= 0`` names a ready basic column for row i; rows with
    ``-1`` get an artificial column. With no artificial the state starts in
    phase 2. ``n_extra_art`` pads inactive artificial columns. The arrays
    are built in numpy exactly as tpulp builds them, then moved once."""
    dtype = _torch_dtype(dtype)
    T, basis, col_active, art_mask, phase = _numpy_state(
        c, A, b, basis_hint, n_extra_art)
    np_state = (T, basis, col_active, art_mask, np.int32(phase),
                np.int32(Status.RUNNING), np.int32(0), np.int32(0),
                np.bool_(False), np.inf)
    return from_numpy_state(np_state, device=device, dtype=dtype)


def from_numpy_state(np_state, device="cuda", dtype=None) -> SimplexState:
    """A state from ten numpy leaves in ``SimplexState`` order: tpulp's
    ``make_state(..., _numpy=True)``, or ``np.asarray`` of each leaf of a
    tpulp state, batched ones included (every leaf with a leading lane
    axis). ``dtype`` defaults to the tableau's own."""
    T = np.asarray(np_state[0])
    dtype = _torch_dtype(T.dtype if dtype is None else dtype)
    dev = torch.device(device)
    kinds = (dtype, torch.int32, torch.bool, torch.bool, torch.int32,
             torch.int32, torch.int32, torch.int32, torch.bool, dtype)
    return SimplexState(*(
        torch.tensor(np.asarray(v), device=dev).to(dt)
        for v, dt in zip(np_state, kinds)))


def to_numpy_state(state: SimplexState) -> tuple:
    """The ten leaves of ``state`` as numpy values with tpulp's dtypes:
    numpy scalars for the 0-d leaves of one problem, arrays for a batch."""
    np_dtype = np.float32 if state.T.dtype == torch.float32 else np.float64
    kinds = (np_dtype, np.int32, bool, bool, np.int32, np.int32, np.int32,
             np.int32, np.bool_, np_dtype)
    return tuple(np.asarray(x.detach().cpu().numpy(), dtype=dt)[()]
                 for x, dt in zip(state, kinds))

"""``solve_lp``: the user entry point of the PyTorch port.

The counterpart of ``tpulp.solve.api``, for one LP on one device: lowering
and equilibration, ``make_state``, the engine choice (rank-1, rank-K
blocked, or the CUDA kernel engine for large tableaus), refinement of the
final basis on the original data with the optimality certificate, and the
precision ladder (refreshed rung at f64, then the exact host simplex).

``device`` is explicit and defaults to ``"cuda"``; without CUDA that
raises instead of quietly running on the CPU. Options that belong to
slices not ported yet raise ``NotImplementedError`` naming the ROADMAP
item that brings them.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ..model.lower import StandardForm, lower_to_standard_form
from ..model.prog import MAX, LinProg

from ..core.state import RULE_DEVEX, SolverOptions, Status, make_state
from .blocked import run_simplex_blocked
from .blocked_kernel import run_simplex_blocked_kernel
from .devex import run_simplex_devex
from .driver import extract_solution, run_simplex
from .dual import run_dual_simplex, warm_state_from_basis
from .refine import (basis_duals, exact_basis_certificate,
                     float_basis_certificate, original_sensitivity,
                     refine_basis_solution)
from .refresh import run_simplex_refreshed

__all__ = [
    "Solution",
    "solve_lp",
    "solve_standard_form",
    "solve_standard_form_host",
    "state_from_standard_form",
]

# tableau sizes (elements) of the 'auto' engine choice, kept from tpulp:
# they encode the TPU's compile-time trade-offs and await H100 measurement
RANK1_BELOW = 200_000
KERNEL_FROM = 4_000_000


@dataclasses.dataclass
class Solution:
    """Result of an LP solve.

    ``objective``/``x`` are in the ORIGINAL problem's sense and variables
    (exact Fractions when refinement ran exactly, floats otherwise);
    ``objective_min`` is the internal minimization value including the
    lowering constant. ``y`` holds the row duals (minimization sense) and
    ``duals``/``reduced_costs`` the original-problem sensitivity when the
    solve asked for them. ``mip_gap`` is a MILP's proven optimality gap
    (incumbent - best open bound) / max(|incumbent|, 1) in the
    minimization sense: 0 when proven optimal, set on the early exits.
    ``rung`` names the precision-ladder rung that produced the answer."""

    status: str
    objective: Optional[Union[float, Fraction]] = None
    x: Optional[Dict[str, Any]] = None
    niter: int = 0
    objective_min: Optional[Union[float, Fraction]] = None
    col_values: Optional[Dict[int, Any]] = None
    basis: Optional[list] = None
    y: Optional[list] = None
    duals: Optional[Dict] = None
    reduced_costs: Optional[Dict[str, Any]] = None
    mip_gap: Optional[float] = None
    rung: Optional[str] = None

    @property
    def is_optimal(self) -> bool:
        return self.status == "optimal"


def _not_ported(option: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{option} is not ported to tpulp_torch yet (ROADMAP queue A, "
        f"{item}); use tpulp.solve_lp for it meanwhile")


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} was asked for but torch.cuda.is_available() "
            "is False; pass device='cpu' to solve on the CPU")
    return dev


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def state_from_standard_form(sf: StandardForm, dtype=torch.float64,
                             n_extra_art: int = 0, device="cuda"):
    """Initial state for a lowered problem on ``device``."""
    c, A, b = sf.to_dense(np.float64)
    return make_state(c, A, b, sf.basis_hint, dtype=dtype,
                      n_extra_art=n_extra_art, device=_device(device))


def solve_standard_form_host(sf: StandardForm, rule: str = "dantzig"
                             ) -> Solution:
    """Exact-rational host solve of a lowered StandardForm: the last rung
    of the precision ladder (tpulp's host classes, which use no jax)."""
    from fractions import Fraction as F

    from ..simplex import Simplex
    from ..tableau import Tableau

    if sf.trivially_infeasible:
        return Solution(status="infeasible")
    if sf.upper is not None:
        # the host oracle has no bounded ratio test: materialize the spans
        from ..model.lower import materialize_simple_bounds

        sf = materialize_simple_bounds(sf)
    tab = Tableau.fromArrays(sf.c, sf.A, sf.b, names=sf.col_names)
    sx = Simplex(tab, on_infeasible="status")
    if sx.getStatus() is not None:
        return Solution(status="infeasible", niter=sx.num_pivots,
                        rung="host-exact")
    status = sx.solve(rule=rule)
    if status.value != "optimal":
        return Solution(status=status.value, niter=sx.num_pivots,
                        rung="host-exact")
    bfs = sx.getBFS()
    xc = [bfs.get(j, F(0)) for j in range(sf.n)]
    z_min = sf.obj_const + sum(
        (sf.c[j] * xc[j] for j in range(sf.n)), F(0))
    return Solution(
        status="optimal",
        objective=sf.objective_value(xc),
        x=sf.recover_solution(xc),
        niter=sx.num_pivots,
        objective_min=z_min,
        col_values={j: xc[j] for j in range(sf.n) if xc[j] != 0},
        basis=list(sx.getBasicSequence()),
        rung="host-exact",
    )


def _warm_frame(state, warm_basis, options: SolverOptions):
    """(state, warm_out) for a warm start from ``warm_basis``: the rebuilt
    frame replaces ``state`` when it is primal feasible; when it is only
    dual feasible, ``warm_out`` is the dual simplex's terminal state; a
    frame that is neither, or not finite, leaves the cold ``state``."""
    wb = np.asarray(warm_basis, np.int32)
    if wb.shape != (state.m,) or (wb.size and (
            int(wb.min()) < 0 or int(wb.max()) >= state.n)):
        raise ValueError(
            f"warm_basis must be {state.m} augmented-column indices in "
            f"[0, {state.n}) for this program structure; got shape "
            f"{wb.shape}")
    # the warm frame starts in phase 2: artificial columns (still priceable
    # in the cold state's phase 1) must not be
    active_cols = state.col_active & ~state.art_cols
    frame = warm_state_from_basis(state.T[2:, :-1], state.T[0, :-1],
                                  active_cols, state.art_cols, wb,
                                  state.T[2:, -1])
    if not bool(torch.isfinite(frame.T).all()):
        return state, None
    bvals = frame.T[2:, -1].cpu().numpy()
    red = frame.T[0, :-1].cpu().numpy()
    active = active_cols.cpu().numpy()
    if bvals.min(initial=0.0) >= -options.feas_tol:
        return frame, None
    if red[active].min(initial=0.0) >= -options.opt_tol:
        return state, run_dual_simplex(frame, options)
    return state, None


def _auto_engine(elems: int, dev: torch.device) -> str:
    if elems < RANK1_BELOW:
        return "rank1"
    if elems >= KERNEL_FROM and dev.type == "cuda":
        return "kernel"
    return "blocked"


def solve_standard_form(
    sf: StandardForm,
    options: Optional[SolverOptions] = None,
    dtype=torch.float64,
    refine: str = "auto",
    fallback: str = "auto",
    duals: bool = False,
    pricing: str = "default",
    driver: str = "auto",
    block: int = 64,
    scale: str = "auto",
    warm_basis=None,
    device="cuda",
    _depth: int = 0,
) -> Solution:
    """Solve a lowered StandardForm on ``device``.

    ``warm_basis``: a basis (augmented-column indices, e.g. the
    ``Solution.basis`` of a same-structure program) to start from instead
    of the slack/artificial basis. Its frame is rebuilt against the current
    (scaled) data by ``warm_state_from_basis``: a primal-feasible frame
    continues with the primal engine, a dual-feasible one re-optimizes with
    the dual simplex, and any other frame (or a singular basis) starts
    cold. Refinement, certificate and ladder are unchanged; escalations
    re-solve cold.

    ``scale``: power-of-two equilibration of the device data ('auto' when
    material, 'force', 'none'); refinement, certificate and duals always
    use the original data. ``pricing``: 'default' picks devex for
    equality-heavy shapes (m >= 64 and at least half the rows need an
    artificial), else Dantzig; 'dantzig' / 'devex' pin one. ``driver``:
    'rank1', 'blocked' (rank-K eta blocks of ``block``), 'kernel' (the CUDA
    kernel engine, K = max(block, 128)), 'refreshed', or 'auto' (rank-1
    below 200k tableau elements, the kernel engine from 4M elements on a
    CUDA device, blocked otherwise). ``fallback='auto'`` climbs the ladder
    on a numeric failure, a failed certificate, or an infeasible/unbounded
    verdict to confirm: the refreshed driver at f64, then the exact host
    simplex; ``'none'`` reports ``numerical_error`` instead."""
    dev = _device(device)
    if options is None:
        options = SolverOptions.for_dtype(dtype)
    if sf.trivially_infeasible:
        return Solution(status="infeasible")
    if sf.upper is not None and any(u is not None for u in sf.upper):
        raise _not_ported("a simple_bounds lowering", "item 8, bounded")
    # ---- equilibration: the device sees scaled data, everything exact
    # (refine / certificate / duals) sees the original ---------------------
    c_d, A_d, b_d = sf.to_dense(np.float64)
    col_scale = None  # x_original = col_scale * x_device
    if scale in ("auto", "force"):
        from ..model.equilibrate import (equilibration_powers_dense,
                                         is_material_scaling,
                                         scaled_dense)

        rp, cp = equilibration_powers_dense(A_d, basis_hint=sf.basis_hint)
        if scale == "force" or is_material_scaling(rp, cp):
            c_d, A_d, b_d = scaled_dense(c_d, A_d, b_d, rp, cp)
            col_scale = np.ldexp(1.0, cp.astype(np.int32))
    elif scale != "none":
        raise ValueError(f"unknown scale {scale!r}")
    state = make_state(c_d, A_d, b_d, sf.basis_hint, dtype=dtype, device=dev)
    if pricing == "default":
        art_rows = sum(1 for h in sf.basis_hint if h < 0)
        if state.m >= 64 and 2 * art_rows >= state.m:
            pricing = "devex"
    if pricing == "dantzig":
        pricing = "default"
    if pricing not in ("default", "devex"):
        raise ValueError(f"unknown pricing {pricing!r}")
    opts_eng = dataclasses.replace(options, rule=RULE_DEVEX) \
        if pricing == "devex" else options

    warm_out = None
    if warm_basis is not None:
        state, warm_out = _warm_frame(state, warm_basis, options)
    elems = (state.m + 2) * (state.n + 1)
    eng = _auto_engine(elems, dev) if driver == "auto" else driver
    if warm_out is not None:
        # the RHS moved (the branch-and-bound child's shape): `warm_out` is
        # the dual simplex's terminal state
        out = warm_out
    elif eng == "rank1":
        out = run_simplex_devex(state, options) if pricing == "devex" \
            else run_simplex(state, options)
    elif eng == "blocked":
        out = run_simplex_blocked(state, opts_eng, block=block)
    elif eng == "kernel":
        out = run_simplex_blocked_kernel(state, opts_eng,
                                         block=max(block, 128))
    elif eng == "refreshed":
        seg = 512
        if (elems >= KERNEL_FROM and dev.type == "cuda"
                and state.T.dtype == torch.float32):
            ref_engine, seg = "kernel", 2048
        elif pricing == "devex" or elems >= RANK1_BELOW:
            ref_engine = "blocked"
        else:
            ref_engine = "rank1"
        out = run_simplex_refreshed(
            c_d, A_d, b_d, sf.basis_hint, opts_eng, dtype=dtype,
            engine=ref_engine, block=block, segment=seg, device=dev)
    else:
        raise ValueError(f"unknown driver {driver!r}")
    status_code = int(out.status)
    status = Status.NAMES.get(status_code, f"status_{status_code}")
    niter = int(out.niter)
    kind = "refreshed" if driver == "refreshed" else "device"
    rung_tag = f"{kind}-{_dtype_name(state.T.dtype)}"

    def _escalate() -> Solution:
        if fallback == "none" or _depth >= 2:
            return Solution(status="numerical_error", niter=niter)
        if _depth == 0:
            # rung 1: the refreshed driver at f64 — refactorization from
            # the original data repairs the drift behind the failure
            opts1 = SolverOptions.for_dtype(
                torch.float64, rule=options.rule,
                max_iters=options.max_iters, degen_tol=options.degen_tol,
                stall_limit=options.stall_limit)
            return solve_standard_form(
                sf, options=opts1, dtype=torch.float64, refine=refine,
                fallback=fallback, duals=duals, pricing=pricing,
                driver="refreshed", block=block, scale=scale, device=dev,
                _depth=1)
        out_host = solve_standard_form_host(sf)
        if duals and out_host.status == "optimal":
            out_host = dataclasses.replace(
                out_host, y=basis_duals(sf, out_host.basis))
        return out_host

    if status == "numerical_error":
        return _escalate()
    if status != "optimal":
        # a float infeasible/unbounded verdict is tolerance-driven and can
        # be false: confirm on the refreshed rung, and exactly on the host
        # where that is affordable (m <= 192)
        if (status in ("infeasible", "unbounded")
                and fallback != "none" and _depth < 2
                and (_depth == 0 or sf.m <= 192)):
            return _escalate()
        return Solution(status=status, niter=niter, rung=rung_tag)

    basis = [int(j) for j in out.basis.cpu().tolist()]
    if refine == "none":
        x_dev, z_dev = extract_solution(out)
        x_np = x_dev.cpu().numpy()
        if col_scale is not None:
            # device values are in scaled coordinates: x = S x' (artificial
            # columns past sf.n carry no scale)
            x_np = x_np.copy()
            ncs = min(col_scale.shape[0], x_np.shape[0])
            x_np[:ncs] *= col_scale[:ncs]
        col_values = {j: float(x_np[j]) for j in range(sf.n) if x_np[j] != 0}
        z_min = float(z_dev) + float(sf.obj_const)
    else:
        try:
            col_values, z_min = refine_basis_solution(sf, basis, mode=refine)
        except (ZeroDivisionError, np.linalg.LinAlgError):
            # singular float basis: the iterates lied about feasibility
            return _escalate()
        # the optimality certificate of the proposed basis (exact at
        # refinable sizes, f64 otherwise): float iterates can converge to a
        # feasible but suboptimal basis
        try:
            if sf.m <= 192:
                primal_ok, dual_ok = exact_basis_certificate(sf, basis)
            else:
                primal_ok, dual_ok = float_basis_certificate(sf, basis)
        except (ZeroDivisionError, np.linalg.LinAlgError):
            return _escalate()
        if not (primal_ok and dual_ok):
            return _escalate()

    # feasibility sanity of the refined basis values
    for v in col_values.values():
        if v < -1e-6:
            return _escalate()

    def colval(j):
        return col_values.get(j, Fraction(0) if refine != "none" else 0.0)

    x = {}
    for name, (terms, const) in sf.recover.items():
        val = const
        for col, coeff in terms:
            val = val + coeff * colval(col)
        x[name] = val
    obj = -z_min if sf.sense == MAX else z_min
    y = None
    if duals:
        mode = "float64" if refine == "none" else refine
        y = basis_duals(sf, basis, mode=mode)
    return Solution(
        status="optimal",
        objective=obj,
        x=x,
        niter=niter,
        objective_min=z_min,
        col_values=dict(col_values),
        basis=basis,
        y=y,
        rung=rung_tag,
    )


def solve_lp(
    prog: Union[LinProg, StandardForm],
    options: Optional[SolverOptions] = None,
    dtype=torch.float64,
    refine: str = "auto",
    fallback: str = "auto",
    duals: bool = False,
    ranging: bool = False,
    certificates: bool = False,
    mesh=None,
    simple_bounds: bool = False,
    pricing: str = "default",
    driver: str = "auto",
    block: int = 64,
    scale: str = "auto",
    warm_start: Optional[Solution] = None,
    device="cuda",
    **opt_overrides,
) -> Solution:
    """Solve an LP (ignoring any integrality) on ``device``.

    ``prog`` is a ``LinProg`` (lowered here) or a ``StandardForm``.
    ``opt_overrides`` are SolverOptions field overrides, e.g.
    ``solve_lp(lp, max_iters=500)``. ``duals=True`` adds the row duals
    ``Solution.y`` and, for a LinProg, the original-problem shadow prices
    and reduced costs. See ``solve_standard_form`` for ``pricing``,
    ``driver``, ``block``, ``scale``, ``refine`` and ``fallback``.

    ``warm_start``: a prior ``Solution`` of a same-structure program (the
    same variables and constraints; the RHS, the objective or both may
    differ). Its basis seeds the solve: an RHS change re-optimizes with the
    dual simplex, an objective change continues with the primal engine
    from the still-feasible frame, and a basis that fits neither starts
    cold (see ``solve_standard_form``'s ``warm_basis``).

    Not ported yet, and raising NotImplementedError: ``mesh``,
    ``simple_bounds``, ``certificates`` and ``ranging``."""
    if mesh is not None:
        raise _not_ported("mesh=", "item 12, multi-GPU")
    if simple_bounds:
        raise _not_ported("simple_bounds=True", "item 8, bounded")
    if certificates:
        raise _not_ported("certificates=True", "item 11, exact-layer "
                          "bindings")
    if ranging:
        raise _not_ported("ranging=True", "item 11, exact-layer bindings")
    dev = _device(device)
    if options is None:
        options = SolverOptions.for_dtype(dtype)
    if opt_overrides:
        options = dataclasses.replace(options, **opt_overrides)
    is_prog = not isinstance(prog, StandardForm)
    sf = lower_to_standard_form(prog) if is_prog else prog
    warm_basis = None
    if warm_start is not None:
        if warm_start.basis is None:
            raise ValueError(
                "warm_start solution carries no basis (presolve-reduced, "
                "early-stopped, or status-only solves don't); re-solve "
                "cold or keep a basis-bearing Solution")
        warm_basis = warm_start.basis
    sol = solve_standard_form(sf, options=options, dtype=dtype,
                              refine=refine, fallback=fallback, duals=duals,
                              pricing=pricing, driver=driver, block=block,
                              scale=scale, warm_basis=warm_basis, device=dev)
    if duals and is_prog and sol.y is not None:
        dmap, rc = original_sensitivity(prog, sf, sol.y)
        sol = dataclasses.replace(sol, duals=dmap, reduced_costs=rc)
    return sol

"""``solve_lp``: the user entry point of the PyTorch port.

The counterpart of ``tpulp.solve.api``, for one LP on one device: lowering
and equilibration, ``make_state``, the engine choice (rank-1, rank-K
blocked, or the CUDA kernel engine for large tableaus; the bounded-variable
driver for a ``simple_bounds`` lowering), refinement of the final basis on
the original data with the optimality certificate, and the precision
ladder (refreshed rung at f64, then the exact host simplex). On top of the
solve: exact Farkas and ray certificates of non-optimal verdicts
(``certificates=True``) and sensitivity ranging (``ranging=True``).

``device`` is explicit and defaults to ``"cuda"``; without CUDA that
raises instead of quietly running on the CPU. ``mesh=`` (a
``torch.distributed`` ``DeviceMesh``, ``tpulp_torch.shard.make_mesh()``)
column-shards the tableau over the mesh's processes and solves with the
sharded drivers of ``tpulp_torch.shard``; every process calls ``solve_lp``
with the same program and gets the same ``Solution``.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..model.lower import (StandardForm, lower_to_standard_form,
                           materialize_simple_bounds)
from ..model.prog import MAX, LinProg

from ..core.state import RULE_DEVEX, SolverOptions, Status, make_state
from .blocked import run_simplex_blocked
from .blocked_kernel import run_simplex_blocked_kernel
from .bounded import (extract_bounded_solution, make_bounded_state,
                      run_simplex_bounded)
from .devex import run_simplex_devex
from .driver import extract_solution, run_simplex
from .dual import run_dual_simplex, warm_state_from_basis
from .farkas import farkas_certificate, ray_certificate
from .ranging import original_ranging, standard_form_ranging
from .refine import (basis_duals, bounded_basis_certificate,
                     exact_basis_certificate, float_basis_certificate,
                     float_bounded_certificate, original_sensitivity,
                     refine_basis_solution, refine_bounded_basis)
from .refresh import run_simplex_refreshed

__all__ = [
    "Solution",
    "solve_lp",
    "solve_standard_form",
    "solve_standard_form_host",
    "state_from_standard_form",
]

# tableau sizes (elements) of the 'auto' engine choice, kept from tpulp.
# chip_smoke.py's phase 5d (f) times the rank-1 walk, the blocked engine
# and the kernel engine on the H100 at four sizes around them (PERF.md);
# the choice between the two rank-K engines is still open, so they stay
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
    ``rung`` names the precision-ladder rung that produced the answer.

    ``cost_ranging`` / ``rhs_ranging`` (``ranging=True``): per-variable
    objective-coefficient and per-constraint rhs intervals ``(lo, hi)``
    (None: unbounded on that side) over which the terminal basis stays
    optimal, in the original problem's sense; a None value marks an entry
    ranging cannot cover (a split free variable, a dropped constant row);
    a StandardForm input is keyed by column and row index. ``at_upper``
    (``simple_bounds`` solves): the terminal basis' at-upper flag of each
    column. ``farkas`` / ``ray`` (``certificates=True``): exact proofs of
    an infeasible verdict (y with ``y.A_j <= 0`` for every column and
    ``y.b > 0`` over the span-materialized rows) or of an unbounded one (d
    with ``A d = 0``, ``d >= 0``, ``c.d = -1``), checked by
    ``verify_farkas`` / ``verify_ray``."""

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
    cost_ranging: Optional[Dict] = None
    rhs_ranging: Optional[Dict] = None
    at_upper: Optional[list] = None
    farkas: Optional[list] = None
    ray: Optional[list] = None

    @property
    def is_optimal(self) -> bool:
        return self.status == "optimal"


def _check_mesh(mesh, dev: torch.device, device) -> None:
    """A ``mesh=`` argument must be a DeviceMesh over ``device``'s kind."""
    if mesh is None:
        return
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                        f"(tpulp_torch.shard.make_mesh()), not "
                        f"{type(mesh).__name__}")
    if mesh.device_type != dev.type:
        raise ValueError(f"the mesh's devices are {mesh.device_type!r} and "
                         f"device={device!r}")


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


def _solve_sharded(state, upper, options: SolverOptions,
                   opts_eng: SolverOptions, pricing: str, mesh, shard_axis,
                   shard_driver: str, shard_block: int):
    """(bout, out): the terminal state of the sharded driver that a mesh
    solve runs, gathered on every process (``bout`` the bounded state, or
    None)."""
    from ..shard import (from_sharded_bounded_state, from_sharded_state,
                         run_simplex_sharded, run_simplex_sharded_blocked,
                         run_simplex_sharded_bounded, to_sharded_bounded_state,
                         to_sharded_state)

    if upper is not None:
        if pricing == "devex":
            raise ValueError(
                "pricing='devex' is not implemented on the SHARDED "
                "bounded-variable driver; use pricing='dantzig' with mesh, "
                "or drop the mesh for the solo bounded devex driver")
        sb = to_sharded_bounded_state(make_bounded_state(state, upper), mesh,
                                      axis=shard_axis)
        bout = from_sharded_bounded_state(
            run_simplex_sharded_bounded(sb, mesh, options, axis=shard_axis),
            state.n, mesh, shard_axis)
        return bout, bout.s
    if shard_driver not in ("blocked", "rank1"):
        raise ValueError(f"unknown shard_driver {shard_driver!r}")
    sh = to_sharded_state(state, mesh, axis=shard_axis)
    if shard_driver == "blocked":
        osh = run_simplex_sharded_blocked(sh, mesh, opts_eng,
                                          block=shard_block, axis=shard_axis)
    else:
        if pricing == "devex":
            raise ValueError("devex pricing on a mesh requires "
                             "shard_driver='blocked'")
        osh = run_simplex_sharded(sh, mesh, options, axis=shard_axis)
    return None, from_sharded_state(osh, state.n, mesh, shard_axis)


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
    mesh=None,
    shard_axis="cols",
    shard_driver: str = "blocked",
    shard_block: int = 64,
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
    simplex; ``'none'`` reports ``numerical_error`` instead.

    A ``simple_bounds`` lowering (finite spans in ``sf.upper``) always runs
    the bounded-variable driver, Dantzig or devex priced; its spans are
    divided by the column scale under equilibration, its refinement and
    certificate keep nonbasic at-upper columns at their spans, and its
    ladder has no refreshed rung: a float32 failure retries the bounded
    driver at float64, anything else goes to the exact host simplex on the
    row-materialized form. ``warm_basis`` raises there (a bounded basis
    carries at-upper flags).

    ``mesh`` (a ``DeviceMesh`` whose device type is ``device``'s)
    column-shards the tableau over the axis or axes ``shard_axis`` and
    solves with the sharded drivers: ``shard_driver='blocked'`` (rank-K
    etas of ``shard_block``, one fused psum a pivot, Dantzig or devex) or
    ``'rank1'`` (Dantzig), and a ``simple_bounds`` lowering with the
    sharded bounded driver (Dantzig; devex raises). The gathered terminal
    state goes through the same refinement, certificate and ladder as a
    solo solve, except that the ladder has no refreshed rung on a mesh: a
    float32 failure retries the sharded solve at float64, anything else
    goes to the exact host simplex. ``warm_basis`` raises with a mesh."""
    dev = _device(device)
    _check_mesh(mesh, dev, device)
    if options is None:
        options = SolverOptions.for_dtype(dtype)
    if sf.trivially_infeasible:
        return Solution(status="infeasible")
    # ---- equilibration: the device sees scaled data, everything exact
    # (refine / certificate / duals) sees the original ---------------------
    c_d, A_d, b_d = sf.to_dense(np.float64)
    upper_dev = sf.upper
    col_scale = None  # x_original = col_scale * x_device
    if scale in ("auto", "force"):
        from ..model.equilibrate import (equilibration_powers_dense,
                                         is_material_scaling,
                                         scaled_dense)

        rp, cp = equilibration_powers_dense(A_d, basis_hint=sf.basis_hint)
        if scale == "force" or is_material_scaling(rp, cp):
            c_d, A_d, b_d = scaled_dense(c_d, A_d, b_d, rp, cp)
            col_scale = np.ldexp(1.0, cp.astype(np.int32))
            if sf.upper is not None:
                upper_dev = [
                    None if u is None else float(u) / col_scale[j]
                    for j, u in enumerate(sf.upper)]
    elif scale != "none":
        raise ValueError(f"unknown scale {scale!r}")
    state = make_state(c_d, A_d, b_d, sf.basis_hint, dtype=dtype, device=dev)
    bounded = sf.upper is not None and any(u is not None for u in sf.upper)
    if warm_basis is not None and (bounded or mesh is not None):
        raise ValueError(
            "warm_basis is supported on the solo tableau path only "
            "(bounded-variable bases carry at_upper flags and sharded "
            "frames a distributed layout; re-solve cold there)")
    if pricing == "default" and not bounded and (
            mesh is None or shard_driver == "blocked"):
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
    bout = None
    if warm_basis is not None:
        state, warm_out = _warm_frame(state, warm_basis, options)
    elems = (state.m + 2) * (state.n + 1)
    eng = _auto_engine(elems, dev) if driver == "auto" else driver
    if mesh is not None:
        bout, out = _solve_sharded(state, upper_dev if bounded else None,
                                   options, opts_eng, pricing, mesh,
                                   shard_axis, shard_driver, shard_block)
    elif bounded:
        # finite spans never became tableau rows: the bounded-variable
        # driver enforces them in its ratio test
        bout = run_simplex_bounded(make_bounded_state(state, upper_dev),
                                   opts_eng)
        out = bout.s
    elif warm_out is not None:
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
        opts1 = SolverOptions.for_dtype(
            torch.float64, rule=options.rule, max_iters=options.max_iters,
            degen_tol=options.degen_tol, stall_limit=options.stall_limit)
        if _depth == 0 and not bounded and mesh is None:
            # rung 1: the refreshed driver at f64 — refactorization from
            # the original data repairs the drift behind the failure
            return solve_standard_form(
                sf, options=opts1, dtype=torch.float64, refine=refine,
                fallback=fallback, duals=duals, pricing=pricing,
                driver="refreshed", block=block, scale=scale, device=dev,
                _depth=1)
        if _depth == 0 and state.T.dtype != torch.float64:
            # the bounded and sharded drivers have no refreshed rung (the
            # refresh driver is tableau-form and solo): retry at f64
            return solve_standard_form(
                sf, options=opts1, dtype=torch.float64, refine=refine,
                fallback=fallback, duals=duals, pricing=pricing,
                scale=scale, mesh=mesh, shard_axis=shard_axis,
                shard_driver=shard_driver, shard_block=shard_block,
                device=dev, _depth=1)
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
    at_upper_np = None if bout is None else bout.at_upper.cpu().numpy()
    if refine == "none":
        x_dev, z_dev = extract_solution(out) if bout is None \
            else extract_bounded_solution(bout)
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
            if bounded:
                col_values, z_min = refine_bounded_basis(
                    sf, basis, at_upper_np, mode=refine)
            else:
                col_values, z_min = refine_basis_solution(sf, basis,
                                                          mode=refine)
        except (ZeroDivisionError, np.linalg.LinAlgError):
            # singular float basis: the iterates lied about feasibility
            return _escalate()
        # the optimality certificate of the proposed basis (exact at
        # refinable sizes, f64 otherwise): float iterates can converge to a
        # feasible but suboptimal basis
        try:
            if bounded and sf.m <= 192:
                primal_ok, dual_ok = bounded_basis_certificate(
                    sf, basis, at_upper_np)
            elif bounded:
                primal_ok, dual_ok = float_bounded_certificate(
                    sf, basis, at_upper_np)
            elif sf.m <= 192:
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
        at_upper=None if at_upper_np is None
        else [bool(v) for v in at_upper_np],
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
    shard_axis="cols",
    shard_driver: str = "blocked",
    shard_block: int = 64,
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

    ``simple_bounds=True`` lowers finite upper bounds without tableau rows
    and solves with the bounded-variable simplex (``solve/bounded.py``).

    ``certificates=True`` attaches an exact proof to an infeasible verdict
    (``Solution.farkas``) or an unbounded one (``Solution.ray``), over the
    span-materialized form. If the exact extraction disproves the verdict,
    the exact host answer replaces it; a ray is attached only once the
    system is shown feasible (no Farkas vector exists), since a ray proves
    unboundedness only of a feasible system (an infeasible one gets the
    host's answer and its Farkas vector).

    ``ranging=True`` adds ``Solution.cost_ranging`` / ``rhs_ranging``
    (``solve/ranging.py``), for bounded solves through the terminal
    basis' at-upper flags. It raises ValueError where the answering rung
    gives no basis to range: a bounded solve answered by the exact host
    rung (no at-upper flags), or a basis with fewer rows than the form (the
    host simplex drops linearly dependent rows).

    ``mesh=tpulp_torch.shard.make_mesh()`` makes this a solve over every
    process of the mesh, one shard each: the tableau is column-sharded
    over ``shard_axis`` and solved with the sharded drivers
    (``shard_driver`` 'blocked' with ``shard_block`` etas, or 'rank1'),
    then gathered, refined and certified like a solo solve (see
    ``solve_standard_form``). Every process calls it with the same
    program and gets the same ``Solution``."""
    dev = _device(device)
    if options is None:
        options = SolverOptions.for_dtype(dtype)
    if opt_overrides:
        options = dataclasses.replace(options, **opt_overrides)
    is_prog = not isinstance(prog, StandardForm)
    sf = lower_to_standard_form(prog, simple_bounds=simple_bounds) \
        if is_prog else prog
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
                              scale=scale, warm_basis=warm_basis, mesh=mesh,
                              shard_axis=shard_axis,
                              shard_driver=shard_driver,
                              shard_block=shard_block, device=dev)
    if duals and is_prog and sol.y is not None:
        dmap, rc = original_sensitivity(prog, sf, sol.y)
        sol = dataclasses.replace(sol, duals=dmap, reduced_costs=rc)
    bounded = sf.upper is not None and any(u is not None for u in sf.upper)
    if certificates and sol.status in ("infeasible", "unbounded"):
        sff = materialize_simple_bounds(sf) if bounded else sf
        if not sff.trivially_infeasible:
            sol = _with_certificate(sol, sff)
    if ranging and sol.is_optimal and sol.basis is not None:
        if bounded and sol.at_upper is None:
            # the exact-host escalation rung materializes bound rows in a
            # different column space and carries no at-upper flags
            raise ValueError(
                "ranging on this simple_bounds solve is unavailable: the "
                "answer came from a rung without at_upper flags "
                f"(rung={sol.rung!r}). Re-solve with simple_bounds=False "
                "for ranging on the row-lowered form")
        if len(sol.basis) != sf.m:
            raise ValueError(
                "ranging on this solve is unavailable: the answer came from "
                f"the {sol.rung!r} rung, whose basis has {len(sol.basis)} "
                f"rows for the form's {sf.m} (the exact host simplex drops "
                "linearly dependent rows); remove the dependent constraints "
                "and re-solve for ranging")
        mode = "float64" if refine == "none" else refine
        rep = standard_form_ranging(sf, sol.basis, mode=mode,
                                    at_upper=sol.at_upper)
        if is_prog:
            crng, rrng = original_ranging(prog, sf, rep)
        else:
            crng = {j: r for j, r in enumerate(rep.cost)}
            rrng = {i: r for i, r in enumerate(rep.rhs)}
        sol = dataclasses.replace(sol, cost_ranging=crng, rhs_ranging=rrng)
    return sol


def _with_certificate(sol: Solution, sff: StandardForm) -> Solution:
    """``sol`` (infeasible or unbounded) with its exact proof attached, or
    the exact host answer where the extraction disproves the verdict."""
    if sol.status == "infeasible":
        farkas = farkas_certificate(sff)
        if farkas is not None:
            return dataclasses.replace(sol, farkas=farkas)
        # the system is feasible: the float status was false
        return solve_standard_form_host(sff)
    ray = ray_certificate(sff)
    if ray is None:
        # no improving ray: the float status was false
        return solve_standard_form_host(sff)
    farkas = farkas_certificate(sff)
    if farkas is None:
        return dataclasses.replace(sol, ray=ray)
    # a ray proves unboundedness only of a feasible system, and this one
    # is infeasible: the host's answer, with its proof
    return dataclasses.replace(solve_standard_form_host(sff), farkas=farkas)

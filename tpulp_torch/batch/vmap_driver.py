"""Batched simplex: many independent LPs in one wave of lanes.

The counterpart of ``tpulp.batch.vmap_driver``. A batched
``SimplexState`` carries a leading lane axis on every field;
``run_simplex_batch`` runs every lane's rank-1 loop to its own exit
(``solve.lanes.primal_lanes``: on the card one launch of the lane kernel,
a block per lane, or past a block's shared memory of the cluster lanes, a
thread-block cluster per lane; on the CPU the rank-1 step vmapped over the
lanes, each
lane frozen once it leaves RUNNING or reaches the budget), so lanes with
different pivot counts share one call. Problems of
different shapes are padded to one shape: each padded row gets its own
unit "pad slack" basic column, extra columns are inactive, and padded
artificial columns keep phase 1 uniform. The batch is the engine under
``tpulp_torch.milp``: every branch-and-bound wave is one batched solve.
``solve_lp_batch(driver="blocked")`` runs the rank-K blocked driver over
the lanes instead, and ``simple_bounds=True`` the bounded-variable step on
a batched ``BoundedState`` (no bound rows in any lane's tableau).
``solve_lp_batch(mesh=...)`` splits the lanes over the mesh's ``batch``
axis and each lane's columns over its ``cols`` axis
(``shard.run_simplex_batch_gspmd``).
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..model.lower import (StandardForm, lower_to_standard_form,
                           materialize_simple_bounds)
from ..model.prog import MAX, LinProg

from ..core.precision import full_precision
from ..core.state import (SimplexState, SolverOptions, Status, _numpy_state,
                          from_numpy_state, make_state)
from ..solve.api import (Solution, _check_mesh, _device,
                         solve_standard_form)
from ..solve.blocked import run_simplex_blocked_batch
from ..solve.bounded import BoundedState, run_simplex_bounded_batch
from ..solve.driver import finish
from ..solve.dual import run_warm_batch
from ..solve.lanes import primal_lanes
from ..solve.refine import (bounded_basis_certificate,
                            exact_basis_certificate, float_basis_certificate,
                            float_bounded_certificate, refine_basis_solution,
                            refine_bounded_basis)

__all__ = [
    "stack_states",
    "unstack_state",
    "make_batched_states",
    "make_batched_bounded_states",
    "run_simplex_batch",
    "pad_batched_columns",
    "solve_lp_batch",
    "extract_batch_solutions",
    "extract_batch_bounded_solutions",
]


def stack_states(states: Sequence[SimplexState]) -> SimplexState:
    """Stack same-shape states along a new leading lane axis."""
    return SimplexState(*(torch.stack(xs, dim=0) for xs in zip(*states)))


def unstack_state(batched: SimplexState, i: int) -> SimplexState:
    """Problem ``i`` of a batched state."""
    return SimplexState(*(x[i] for x in batched))


def _padded_arrays(sf: StandardForm, m_max: int, n_base: int):
    """One problem's dense arrays padded to (m_max, n_base) non-artificial
    columns: each zero row gets a fresh unit basic column (a pad slack),
    extra columns stay zero and costless."""
    c, A, b, hint = *sf.to_dense(np.float64), list(sf.basis_hint)
    m, n = A.shape
    cp = np.zeros((n_base,))
    cp[:n] = c
    Ap = np.zeros((m_max, n_base))
    Ap[:m, :n] = A
    bp = np.zeros((m_max,))
    bp[:m] = b
    for k in range(m_max - m):
        Ap[m + k, n + k] = 1.0  # pad slack
        hint.append(n + k)
    return cp, Ap, bp, hint


def make_batched_states(sfs: Sequence[StandardForm], dtype=torch.float64,
                        return_host_art: bool = False, device="cuda"):
    """Lower a list of StandardForms to ONE batched state of uniform shape
    on ``device``: built in numpy as tpulp builds them, stacked on the host,
    one transfer per field. Lowerings with simple bounds are refused (the
    batched step has no bounded ratio test; ``materialize_simple_bounds``
    turns them into rows). ``return_host_art=True`` also returns the host
    copy of the batched ``art_cols``."""
    if not sfs:
        raise ValueError("empty batch")
    if any(sf.upper is not None and any(u is not None for u in sf.upper)
           for sf in sfs):
        raise ValueError(
            "batched solving needs row-based bounds: materialize "
            "simple_bounds lowerings first (model.lower."
            "materialize_simple_bounds)")
    dims = [(sf.m, sf.n, sum(1 for h in sf.basis_hint if h < 0))
            for sf in sfs]
    m_max = max(d[0] for d in dims)
    n_base = max(d[1] + (m_max - d[0]) for d in dims)
    art_max = max(d[2] for d in dims)
    lanes = [_numpy_state(*_padded_arrays(sf, m_max, n_base),
                          n_extra_art=art_max - n_art)
             for sf, (_, _, n_art) in zip(sfs, dims)]
    T, basis, col_active, art_cols, phase = (
        np.stack(xs, axis=0) for xs in zip(*lanes))
    B = len(sfs)
    zeros = np.zeros((B,), np.int32)
    state = from_numpy_state(
        (T, basis, col_active, art_cols, phase.astype(np.int32),
         zeros + Status.RUNNING, zeros, zeros, np.zeros((B,), bool),
         np.full((B,), np.inf)), device=device, dtype=dtype)
    if return_host_art:
        return state, art_cols
    return state


def make_batched_bounded_states(sfs: Sequence[StandardForm],
                                dtype=torch.float64, device="cuda"
                                ) -> BoundedState:
    """A batched BoundedState from simple_bounds lowerings: the span
    vectors are padded beside the tableaus, structural columns carrying
    their finite spans and pad slacks, extra columns and artificials +inf
    (they never flip)."""
    plain = [dataclasses.replace(sf, upper=None) for sf in sfs]
    batched = make_batched_states(plain, dtype=dtype, device=device)
    n_batched = batched.T.shape[2] - 1
    uppers = np.full((len(sfs), n_batched), np.inf)
    for k, sf in enumerate(sfs):
        for j, u in enumerate(sf.upper or []):
            if u is not None:
                uppers[k, j] = float(u)
    dev = batched.T.device
    return BoundedState(
        s=batched,
        upper=torch.tensor(uppers, device=dev).to(batched.T.dtype),
        at_upper=torch.zeros((len(sfs), n_batched), dtype=torch.bool,
                             device=dev),
    )


def pad_batched_columns(batched: SimplexState, multiple: int
                        ) -> SimplexState:
    """The batched tableau's width ``n+1`` padded to a multiple of
    ``multiple`` with zero columns inserted before the RHS column, never
    priced (``col_active`` False) and never basic, so walks are unchanged:
    the divisibility that ``shard.run_simplex_batch_gspmd`` needs of the
    ``cols`` axis."""
    width = batched.T.shape[2]
    pad = (-width) % multiple
    if pad == 0:
        return batched
    B, M, _ = batched.T.shape
    T = torch.cat([batched.T[:, :, :-1],
                   torch.zeros((B, M, pad), dtype=batched.T.dtype,
                               device=batched.T.device),
                   batched.T[:, :, -1:]], dim=2)
    fmask = torch.zeros((B, pad), dtype=torch.bool, device=batched.T.device)
    return batched._replace(
        T=T,
        col_active=torch.cat([batched.col_active, fmask], dim=1),
        art_cols=torch.cat([batched.art_cols, fmask], dim=1))


def mesh_axis_size(mesh, axis) -> int:
    """The size of ``axis`` in ``mesh``; 1 where the mesh has no such
    axis."""
    names = tuple(mesh.mesh_dim_names or ())
    return mesh.size(names.index(axis)) if axis in names else 1


@full_precision()
def run_simplex_batch(batched: SimplexState,
                      opts: SolverOptions | None = None) -> SimplexState:
    """Run the rank-1 step over every lane to termination or the budget."""
    if opts is None:
        opts = SolverOptions.for_dtype(batched.T.dtype)
    m = batched.T.shape[1] - 2
    n = batched.T.shape[2] - 1
    stall_limit = opts.resolved_stall_limit(m, n)
    return finish(primal_lanes(batched, opts, stall_limit, opts.max_iters))


def solve_lp_batch(
    progs: Sequence[Union[LinProg, StandardForm]],
    options: SolverOptions | None = None,
    dtype=torch.float64,
    refine: str = "auto",
    return_state: bool = False,
    pad_to: int | None = None,
    driver: str = "rank1",
    block: int = 32,
    simple_bounds: bool = False,
    mesh=None,
    batch_axis: str = "batch",
    cols_axis: str = "cols",
    warm_start: Optional[Solution] = None,
    device="cuda",
    **opt_overrides,
) -> List[Solution]:
    """Solve a batch of LPs in one wave on ``device``; one Solution each.

    ``warm_start``: a prior ``Solution`` of the same-structure program.
    The batch must share one constraint matrix, objective and lowering
    layout and differ only in the RHS (scenarios). Every lane starts from
    its basis in one dual-simplex wave (``run_warm_batch``), then refines
    and certifies as usual; a lane the wave does not settle re-solves solo
    through the ladder, so statuses keep ``solve_lp``'s confirmation.
    The plain row-form batch only: with ``simple_bounds`` it raises.

    ``driver="blocked"`` runs the rank-K blocked driver over the lanes
    (``solve.blocked.run_simplex_blocked_batch``, eta blocks of
    ``block``), for lanes whose tableaus are too large to rewrite whole
    every pivot. On the card a block of every lane is one launch of
    ``blocked_cluster`` with a lane axis (one thread-block cluster a lane),
    one B1 flush and one ray launch over the lanes, with one host read of
    the lanes' status a block; past the cluster's plan (a wide LP, a
    ``block`` past it) each lane's solo walk runs in turn on
    ``blocked_grid`` (one cooperative launch a block, on the plan that
    ``blocked_grid_plan`` picks for the frame). On the CPU it is the eager
    vmapped loop. ``simple_bounds=True``
    lowers finite upper bounds without rows and runs the bounded-variable
    step over the lanes; otherwise spans become explicit bound rows (the
    same optimum).

    ``mesh`` (a ``DeviceMesh`` whose device type is ``device``'s, every
    process calling alike) splits the lanes over ``batch_axis`` and each
    lane's columns over ``cols_axis`` where the mesh has it
    (``shard.run_simplex_batch_gspmd``): lanes are padded to a multiple of
    the batch axis's size by replicating lane 0, the tableau width to the
    cols axis's size, and every process extracts the same Solutions from
    the gathered terminal state. It runs the rank-1 driver on row-form
    bounds.

    ``return_state=True`` returns ``(solutions, out_state, lane_of)``:
    the terminal batched state and the lane of each problem (-1 for a
    trivially infeasible one that never reached the device). ``pad_to``
    replicates lane 0 up to a fixed batch width; padded lanes run but are
    never extracted."""
    dev = _device(device)
    _check_mesh(mesh, dev, device)
    if options is None:
        options = SolverOptions.for_dtype(dtype)
    if opt_overrides:
        options = dataclasses.replace(options, **opt_overrides)
    sfs = [p if isinstance(p, StandardForm)
           else lower_to_standard_form(p, simple_bounds=simple_bounds)
           for p in progs]
    if not simple_bounds:
        # simple_bounds lowerings become explicit bound rows (the same
        # optimum): the unbounded batched drivers have no bounded ratio test
        sfs = [materialize_simple_bounds(sf) if sf.upper is not None
               else sf for sf in sfs]
    solvable = [i for i, sf in enumerate(sfs) if not sf.trivially_infeasible]
    results: List[Solution] = [Solution(status="infeasible")] * len(sfs)
    if not solvable:
        return (results, None, [-1] * len(sfs)) if return_state else results
    if warm_start is not None:
        if simple_bounds or mesh is not None:
            raise ValueError(
                "warm_start batching supports the plain row-form batch "
                "path only (no mesh, no simple_bounds)")
        out = _solve_batch_warm(sfs, solvable, warm_start, options, dtype,
                                refine, results, dev)
    else:
        sf_batch = [sfs[i] for i in solvable]
        if pad_to is not None and len(sf_batch) < pad_to:
            sf_batch = sf_batch + [sf_batch[0]] * (pad_to - len(sf_batch))
        if mesh is not None:
            if simple_bounds:
                raise ValueError(
                    "mesh batching has no sharded bounded-variable wave "
                    "yet; use simple_bounds=False (bounds become explicit "
                    "rows)")
            if driver != "rank1":
                raise ValueError(
                    "mesh batching runs the lane-sharded rank-1 wave; use "
                    "driver='rank1'")
            from ..shard.sharded import run_simplex_batch_gspmd

            lane_pad = (-len(sf_batch)) % mesh_axis_size(mesh, batch_axis)
            sf_batch = sf_batch + [sf_batch[0]] * lane_pad
            batched = pad_batched_columns(
                make_batched_states(sf_batch, dtype=dtype, device=dev),
                mesh_axis_size(mesh, cols_axis))
            out = run_simplex_batch_gspmd(batched, mesh, options,
                                          batch_axis=batch_axis,
                                          cols_axis=cols_axis)
            extracted = extract_batch_solutions(
                [sfs[i] for i in solvable], out, refine)
        elif simple_bounds:
            bout = run_simplex_bounded_batch(make_batched_bounded_states(
                sf_batch, dtype=dtype, device=dev), options)
            out = bout.s
            extracted = extract_batch_bounded_solutions(
                [sfs[i] for i in solvable], bout, refine)
        else:
            batched = make_batched_states(sf_batch, dtype=dtype, device=dev)
            if driver == "blocked":
                out = run_simplex_blocked_batch(batched, options, block=block)
            elif driver == "rank1":
                out = run_simplex_batch(batched, options)
            else:
                raise ValueError(f"unknown batch driver {driver!r}")
            extracted = extract_batch_solutions(
                [sfs[i] for i in solvable], out, refine)
        for k, i in enumerate(solvable):
            results[i] = extracted[k]
    if return_state:
        lane_of = [-1] * len(sfs)
        for k, i in enumerate(solvable):
            lane_of[i] = k
        return results, out, lane_of
    return results


def _solve_batch_warm(sfs, solvable, warm_start, options, dtype, refine,
                      results, dev) -> SimplexState:
    """One warm dual-simplex wave over same-structure RHS scenarios: the
    shared root frame, per-lane b and the warm basis on every lane. Lanes
    whose verdict is not a certified optimum re-solve solo. Fills
    ``results`` and returns the terminal batched state."""
    if warm_start.basis is None:
        raise ValueError(
            "warm_start solution carries no basis (status-only or "
            "presolve-reduced solves don't); re-solve cold")
    dense = {i: sfs[i].to_dense(np.float64) for i in solvable}
    sf0 = sfs[solvable[0]]
    c0, A0, b0 = dense[solvable[0]]
    for i in solvable[1:]:
        sf = sfs[i]
        ci, Ai, _ = dense[i]
        if (sf.m != sf0.m or sf.n != sf0.n
                or list(sf.basis_hint) != list(sf0.basis_hint)
                or not np.array_equal(Ai, A0)
                or not np.array_equal(ci, c0)):
            raise ValueError(
                "warm_start batching requires SAME-STRUCTURE scenarios "
                "(identical constraint matrix, objective, and lowering "
                f"layout; program {i} differs — only the RHS may vary)")
    st0 = make_state(c0, A0, b0, sf0.basis_hint, dtype=dtype, device=dev)
    wb = np.asarray(warm_start.basis, np.int32)
    if wb.shape != (st0.m,) or (wb.size and (
            int(wb.min()) < 0 or int(wb.max()) >= st0.n)):
        raise ValueError(
            f"warm_basis must be {st0.m} augmented-column indices in "
            f"[0, {st0.n}) for this program structure; got shape "
            f"{wb.shape}")
    # phase-2 frames: artificial columns must not be priceable
    active = st0.col_active & ~st0.art_cols
    b_mat = np.stack([dense[i][2] for i in solvable])
    basis_mat = np.tile(wb, (len(solvable), 1))
    out = run_warm_batch(st0.T[2:, :-1], st0.T[0, :-1], active,
                         st0.art_cols, basis_mat, b_mat, opts=options)
    extracted = extract_batch_solutions(
        [sfs[i] for i in solvable], out, refine)
    for k, i in enumerate(solvable):
        sol = extracted[k]
        if sol.status != "optimal":
            # float wave verdicts are unconfirmed; the solo ladder decides
            sol = solve_standard_form(sfs[i], options=options, dtype=dtype,
                                      refine=refine, device=dev)
        results[i] = sol
    return out


def extract_batch_solutions(sfs: Sequence[StandardForm], out: SimplexState,
                            refine: str, prefetched=None) -> List[Solution]:
    """One Solution per StandardForm from the terminal batched state; lane
    k is ``sfs[k]`` (trailing padded lanes are ignored). ``prefetched``
    optionally supplies host copies of ``(statuses, niters, bases,
    corners, art_cols)`` already read in one fetch."""
    if prefetched is not None:
        statuses, niters, bases, corners, art_cols_np = prefetched
    else:
        statuses = out.status.cpu().numpy()
        niters = out.niter.cpu().numpy()
        bases = out.basis.cpu().numpy()
        corners = out.T[:, 0, -1].cpu().numpy()
        art_cols_np = out.art_cols.cpu().numpy()
    rhs_np = out.T[:, 2:, -1].cpu().numpy() if refine == "none" else None
    results: List[Solution] = []
    for k, sf in enumerate(sfs):
        status = Status.NAMES.get(int(statuses[k]), "unknown")
        if status != "optimal":
            results.append(Solution(status=status, niter=int(niters[k])))
            continue
        results.append(_extract_one(
            sf, [int(j) for j in bases[k]], float(-corners[k]),
            int(niters[k]), refine, art_cols_np[k],
            None if rhs_np is None else rhs_np[k]))
    return results


def _remap(sf: StandardForm, basis_cols, art_cols_lane: np.ndarray) -> list:
    """One lane's basis in ``sf``'s own column space."""
    # only this problem's real rows; padded rows hold pad slacks or padded
    # artificials, which do not exist in sf's column space
    basis = [int(j) for j in basis_cols[:sf.m]]
    # batched column -> sf column: structural columns coincide ([0, sf.n));
    # this problem's artificials start at the first art column in the
    # batched layout but at sf.n in refine's convention
    n_batched = art_cols_lane.shape[0]
    art_start = int(art_cols_lane.argmax()) if bool(art_cols_lane.any()) \
        else n_batched
    return [j if j < sf.n else (sf.n + (j - art_start)
                                if j >= art_start else j)
            for j in basis]


def _recover_x(sf: StandardForm, col_values, zero) -> dict:
    """The user's variables from standard-form column values."""
    x = {}
    for name, (terms, const) in sf.recover.items():
        v = const
        for col, coeff in terms:
            v = v + coeff * col_values.get(col, zero)
        x[name] = v
    return x


def extract_batch_bounded_solutions(sfs: Sequence[StandardForm],
                                    bout: BoundedState, refine: str
                                    ) -> List[Solution]:
    """One Solution per StandardForm from a terminal batched BoundedState:
    each lane's basis is remapped to its problem's columns as in
    ``extract_batch_solutions``, then refined and certified by the bounded
    functions (nonbasic at-upper columns sit exactly at their spans)."""
    out = bout.s
    statuses = out.status.cpu().numpy()
    niters = out.niter.cpu().numpy()
    bases = out.basis.cpu().numpy()
    art_cols_np = out.art_cols.cpu().numpy()
    at_upper_np = bout.at_upper.cpu().numpy()
    mode = "float64" if refine == "none" else refine
    results: List[Solution] = []
    for k, sf in enumerate(sfs):
        status = Status.NAMES.get(int(statuses[k]), "unknown")
        niter = int(niters[k])
        if status != "optimal":
            results.append(Solution(status=status, niter=niter))
            continue
        remapped = _remap(sf, bases[k], art_cols_np[k])
        # structural columns coincide in [0, sf.n); pads and artificials
        # carry infinite spans and are never at upper
        at_up = at_upper_np[k]
        try:
            col_values, z_min = refine_bounded_basis(sf, remapped, at_up,
                                                     mode=mode)
            if sf.m <= 192:
                primal_ok, dual_ok = bounded_basis_certificate(
                    sf, remapped, at_up)
            else:
                primal_ok, dual_ok = float_bounded_certificate(
                    sf, remapped, at_up)
        except (ZeroDivisionError, np.linalg.LinAlgError):
            results.append(Solution(status="numerical_error", niter=niter))
            continue
        if not (primal_ok and dual_ok):
            results.append(Solution(status="numerical_error", niter=niter))
            continue
        results.append(Solution(
            status="optimal", objective=-z_min if sf.sense == MAX else z_min,
            x=_recover_x(sf, col_values, Fraction(0)), niter=niter,
            objective_min=z_min, col_values=dict(col_values),
            basis=remapped))
    return results


def _extract_one(sf: StandardForm, basis_cols, z_float, niter, refine,
                 art_cols_lane: np.ndarray,
                 rhs_lane: Optional[np.ndarray]) -> Solution:
    """Refine and recover one lane's solution on the host."""
    remapped = _remap(sf, basis_cols, art_cols_lane)
    if refine == "none":
        z_min = z_float + float(sf.obj_const)
        obj = -z_min if sf.sense == MAX else z_min
        b = rhs_lane[:sf.m]
        vals = {j: float(b[k2]) for k2, j in enumerate(remapped) if j < sf.n}
        return Solution(status="optimal", objective=obj,
                        x=_recover_x(sf, vals, 0.0), niter=niter,
                        objective_min=z_min, col_values=vals, basis=remapped)
    try:
        col_values, z_min = refine_basis_solution(sf, remapped, mode=refine)
    except (ZeroDivisionError, np.linalg.LinAlgError):
        return Solution(status="numerical_error", niter=niter)
    # the certificate follows the refine mode: a caller that chose f64
    # refinement (the MILP bounding waves, which verify incumbents exactly
    # themselves) pays no rational certificate per lane
    mode = refine
    if mode == "auto":
        mode = "exact" if sf.m <= 192 else "float64"
    try:
        if mode == "exact":
            primal_ok, dual_ok = exact_basis_certificate(sf, remapped)
        else:
            primal_ok, dual_ok = float_basis_certificate(sf, remapped)
    except (ZeroDivisionError, np.linalg.LinAlgError):
        return Solution(status="numerical_error", niter=niter)
    if not (primal_ok and dual_ok):
        return Solution(status="numerical_error", niter=niter)
    obj = -z_min if sf.sense == MAX else z_min
    return Solution(status="optimal", objective=obj,
                    x=_recover_x(sf, col_values, Fraction(0)), niter=niter,
                    objective_min=z_min, col_values=dict(col_values),
                    basis=remapped)

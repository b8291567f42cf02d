"""Branch-and-bound MILP over batched LP relaxations, on one device.

The counterpart of ``tpulp.milp.bnb``: the same tree, the same statuses
and the same exact answers.

* The root is lowered once with ``integer_bound_rows=True``: every integer
  variable owns a <=-row and a >=-row, so a node differs from the root only
  in ``b`` and a wave of nodes is one batched solve of one shape. The
  batched template lives on the device; a cold wave uploads just its
  (B, m) right-hand sides.
* Children warm-start from their parent's terminal frame, parked in a
  device-resident state pool: the child's b moves through one slack or
  surplus column and the dual simplex re-optimizes (``solve.dual``).
* With float bounding, up to ``device_generations`` generations are
  expanded on the device per host round trip (``run_expand_generation``),
  and the chain's summaries come home in one read. The chain decides the
  tree's shape (node order and every ``BnbStats`` counter), so it is kept
  for parity with tpulp.
* Bounds are exact rationals at ``m <= exact_max_m`` (``refine='auto'``)
  and float64 with a pruning margin above; every incumbent is verified by
  an exact basis solve, so the reported optimum is exact either way.
* With ``mesh=`` the waves run over a ``(batch, cols)`` DeviceMesh
  (``shard.sharded_waves``); every process runs this scheduler on
  replicated values. ``node_encoding='spans'`` branches on bound vectors
  instead of rows (``milp.spans``).
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
import time
from fractions import Fraction
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..model.lower import StandardForm, lower_to_standard_form
from ..model.prog import LinProg

from ..batch.vmap_driver import (extract_batch_solutions, make_batched_states,
                                 mesh_axis_size, pad_batched_columns,
                                 run_simplex_batch)
from ..core.state import SimplexState, SolverOptions, Status, _torch_dtype
from ..solve.api import (Solution, _check_mesh, _device,
                         solve_standard_form)
from ..solve.dual import (new_pool, pack_wave_summary, pool_write,
                          run_expand_generation, run_warm_batch,
                          run_warm_wave)
from ..solve.refine import exact_basis_solve

__all__ = ["solve_milp", "BnbStats"]

# hard ceiling on the warm-start state pool (slots of (m+2, n+1) parent
# frames on the device); when the frontier outgrows the pool, overflow
# children solve cold. Module-level so tests can shrink it.
POOL_CAP_MAX = 2048

# the per-wave pool-invariant audit (tests turn it on); O(pool_cap) Python
# per wave
POOL_DEBUG = False

# branch values above this magnitude are recomputed exactly from the
# node's terminal basis before the floor/ceil split
EXACT_BRANCH_ABOVE = 2.0 ** 20


@dataclasses.dataclass
class BnbStats:
    nodes_solved: int = 0
    waves: int = 0
    nodes_pruned_bound: int = 0
    nodes_pruned_infeasible: int = 0
    incumbent_updates: int = 0
    solo_resolves: int = 0  # numerical_error / iteration_limit lanes re-run
    warm_nodes: int = 0     # nodes solved by dual-simplex warm start
    warm_pivots: int = 0    # total pivots across warm-started nodes
    pseudocost_updates: int = 0  # learned (var, direction) observations
    # wall time per wave phase (seconds). The wave engines read a "lane
    # running" flag per chunk, so their host loops block: t_device holds
    # the engines and the summary fetches, t_assemble the host packing
    t_assemble: float = 0.0  # frontier pop, node forms, upload packing
    t_device: float = 0.0    # wave engines + blocking summary fetch
    t_process: float = 0.0   # summary unpack, branching, child push
    t_verify: float = 0.0    # exact incumbent verification
    # device-side generation chaining: generations expanded on the device
    # without a host round trip, and the nodes they solved
    gen_waves: int = 0
    gen_nodes: int = 0
    # device bytes of the state pool (sink row included); on a mesh, this
    # process's: its column shard of every slot
    pool_bytes: int = 0


Bounds = Dict[str, Tuple[Fraction, Fraction]]


def _node_standard_form(root_sf: StandardForm, bounds: Bounds) -> StandardForm:
    """The node's StandardForm: the root with only ``b`` rewritten."""
    b = list(root_sf.b)
    for name, (lb, ub) in bounds.items():
        le_row, ge_row = root_sf.int_bound_rows[name]
        shift = root_sf.int_shift[name]
        b[le_row] = ub - shift
        b[ge_row] = lb - shift
    return dataclasses.replace(root_sf, b=b)


def _most_fractional(values: Dict[str, Fraction]) -> Optional[str]:
    """Branching rule: the integer var whose value is farthest from integral."""
    best, best_frac = None, Fraction(0)
    for name, val in values.items():
        frac = val - Fraction(math.floor(val))
        dist = min(frac, 1 - frac)
        if dist > best_frac:
            best, best_frac = name, dist
    return best


class _Pseudocosts:
    """Per-variable pseudocosts: average LP-bound degradation per unit of
    fractional distance, learned from solved children. Selection uses the
    product rule ``max(down_est, eps) * max(up_est, eps)``; unobserved
    directions fall back to the global average, and with no observations
    at all the rule is most-fractional."""

    EPS = 1e-6

    def __init__(self):
        self.up: Dict[str, Tuple[float, int]] = {}
        self.down: Dict[str, Tuple[float, int]] = {}
        self.updates = 0

    def record(self, name: str, direction: str, degradation: float,
               dist: float):
        if dist <= 0:
            return
        store = self.up if direction == "up" else self.down
        s, c = store.get(name, (0.0, 0))
        store[name] = (s + max(degradation, 0.0) / dist, c + 1)
        self.updates += 1

    def _avg(self, store, name):
        s, c = store.get(name, (0.0, 0))
        return (s / c) if c else None

    def _global_avg(self):
        tot, cnt = 0.0, 0
        for store in (self.up, self.down):
            for s, c in store.values():
                tot += s
                cnt += c
        return (tot / cnt) if cnt else None

    def select(self, values: Dict[str, Fraction]) -> Optional[str]:
        fallback = self._global_avg()
        if fallback is None:
            return _most_fractional(values)
        best, best_score = None, -1.0
        for name, val in values.items():
            f = float(val - Fraction(math.floor(val)))
            dist = min(f, 1 - f)
            if dist == 0:
                continue
            dn = self._avg(self.down, name)
            up = self._avg(self.up, name)
            dn = fallback if dn is None else dn
            up = fallback if up is None else up
            score = max(dn * f, self.EPS) * max(up * (1 - f), self.EPS)
            if score > best_score:
                best, best_score = name, score
        return best


def _refresh_template(template: SimplexState, b_mat: torch.Tensor,
                      art_row_mask: torch.Tensor) -> SimplexState:
    """The device-resident batched template with per-lane RHS vectors: the
    b column and the phase-1 corner (-sum of b over artificial rows) are
    all that differ between nodes."""
    T = template.T.clone()
    T[:, 2:, -1] = b_mat
    T[:, 1, -1] = -(b_mat * art_row_mask[None, :]).sum(dim=1)
    return template._replace(T=T)


def _int_recover_matrix(sf: StandardForm, names: List[str], n_batched: int,
                        np_dtype) -> Tuple[np.ndarray, np.ndarray]:
    """(R, const): dense recover map for the branchable integer vars, padded
    to the batched column width."""
    R = np.zeros((len(names), n_batched), dtype=np_dtype)
    const = np.zeros((len(names),), dtype=np_dtype)
    for i, name in enumerate(names):
        terms, c = sf.recover[name]
        const[i] = float(c)
        for col, coeff in terms:
            R[i, col] = float(coeff)
    return R, const


def solve_milp(
    prog: Union[LinProg, StandardForm],
    options: Optional[SolverOptions] = None,
    dtype=torch.float64,
    batch_size: int = 64,
    max_nodes: int = 100_000,
    time_limit: Optional[float] = None,
    gap_tol: float = 0.0,
    refine: str = "auto",
    exact_max_m: int = 32,
    int_tol: float = 1e-6,
    return_stats: bool = False,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 1,
    resume_from: Optional[str] = None,
    presolve: bool = True,
    branching: str = "most_fractional",
    node_encoding: str = "rows",
    mesh=None,
    batch_axis: str = "batch",
    cols_axis: str = "cols",
    device_generations: int = 6,
    device="cuda",
    **opt_overrides,
):
    """Solve a mixed-integer LinProg by branch-and-bound on ``device``.

    Returns a Solution (status optimal / infeasible / unbounded /
    node_limit / time_limit / gap_limit) in the original sense and
    variables; with ``return_stats=True``, ``(Solution, BnbStats)``.

    ``time_limit`` (seconds, checked at wave boundaries) and ``gap_tol``
    (stop once the proven relative gap between the exact incumbent and the
    best open bound is at most this) return the incumbent under a status
    naming the reason, with ``mip_gap`` set; 'optimal' stays reserved for
    gap-zero proofs.

    ``refine``: 'exact' bounds every node in rationals, 'float64' in f64
    with a pruning safety margin, 'auto' picks exact for ``m <=
    exact_max_m``. Incumbents are always verified by an exact basis solve.
    ``branching``: 'most_fractional' or 'pseudocost'.

    ``device_generations`` > 1 expands up to that many generations on the
    device per host round trip; it applies with float bounding,
    most-fractional branching and integer bounds within +-2^20, and 0 or 1
    turns it off. Pruning inside a chain uses only the exact incumbent from
    the chain's start.

    ``checkpoint_path`` writes the frontier and incumbent every
    ``checkpoint_every`` waves (exact 'p/q' JSON, ``tpulp_torch.io``, the
    format of ``tpulp.io.checkpoint``); ``resume_from`` restarts from such
    a file, tpulp's included.

    ``mesh`` (a ``DeviceMesh`` whose device type is ``device``'s, every
    process calling alike) runs every wave over it: the node template,
    the state pool and the waves' states split each lane's columns over
    ``cols_axis`` (where the mesh has it), and each wave's lanes over
    ``batch_axis``; ``batch_size`` must be a multiple of that axis's size.
    The scheduler, the pool bookkeeping, pruning and the exact incumbent
    checks are unchanged, and every process returns the same Solution.

    ``node_encoding='spans'`` (``milp.spans``) lowers the root with simple
    bounds and branches by rewriting bound vectors: no bound rows, cold
    waves of the bounded batch driver. It takes no checkpoint, resume,
    ``time_limit`` or ``gap_tol``, nor a mesh, and needs a finite lower
    bound on every integer variable."""
    dev = _device(device)
    _check_mesh(mesh, dev, device)
    _t_solve0 = time.perf_counter()

    def _time_left():
        """Remaining wall budget to pass into recursive sub-solves."""
        if time_limit is None:
            return None
        return max(0.0, time_limit - (time.perf_counter() - _t_solve0))

    def _agree(flag: bool) -> bool:
        """A host decision every process of the mesh takes alike: true if
        it holds on any process (a clock read differs between them)."""
        if mesh is None:
            return flag
        from ..shard.sharded_waves import any_process

        return any_process(mesh, flag)

    if options is None:
        options = SolverOptions.for_dtype(dtype)
    if opt_overrides:
        options = dataclasses.replace(options, **opt_overrides)
    if isinstance(prog, StandardForm):
        raise TypeError("solve_milp needs the LinProg (it re-bounds integer "
                        "variables); pass the program, not a StandardForm")

    if presolve:
        # exact root presolve (MILP-safe): it also re-runs on resume, since
        # it is a deterministic function of ``prog``; the checkpoint's
        # branch-variable list is validated below
        from ..model.presolve import presolve as _presolve

        res = _presolve(prog)
        if res.status is not None:
            sol = Solution(status=res.status)
            return (sol, BnbStats()) if return_stats else sol
        if res.unbounded_if_feasible:
            # on the mesh, so that its time checks go through _agree
            feas = solve_milp(res.prog, options=options, dtype=dtype,
                              batch_size=batch_size, max_nodes=max_nodes,
                              time_limit=_time_left(),
                              refine=refine, exact_max_m=exact_max_m,
                              int_tol=int_tol, presolve=False, mesh=mesh,
                              batch_axis=batch_axis, cols_axis=cols_axis,
                              device=dev)
            if feas.status == "infeasible":
                sol = Solution(status="infeasible")
            elif feas.status == "optimal" or feas.x is not None:
                # feasibility proven (optimum or an incumbent on node_limit)
                sol = Solution(status="unbounded")
            else:
                # feasibility unproven: the indeterminate status stands
                sol = Solution(status=feas.status)
            return (sol, BnbStats()) if return_stats else sol
        if not res.prog.allVarNames():   # fully solved by presolve
            obj = res.prog.objective.expr.getConstant()
            sol = Solution(status="optimal", objective=obj,
                           x=res.recover({}))
            return (sol, BnbStats()) if return_stats else sol
        if res.fixed or res.removed_rows or res.removed_vars:
            out = solve_milp(res.prog, options=options, dtype=dtype,
                             batch_size=batch_size, max_nodes=max_nodes,
                             time_limit=_time_left(), gap_tol=gap_tol,
                             refine=refine, exact_max_m=exact_max_m,
                             int_tol=int_tol, return_stats=return_stats,
                             checkpoint_path=checkpoint_path,
                             checkpoint_every=checkpoint_every,
                             resume_from=resume_from,
                             presolve=False, branching=branching,
                             node_encoding=node_encoding, mesh=mesh,
                             batch_axis=batch_axis, cols_axis=cols_axis,
                             device_generations=device_generations,
                             device=dev, **opt_overrides)
            sol, st = out if return_stats else (out, None)
            if sol.x is not None:
                sol = dataclasses.replace(
                    sol, x=res.recover(sol.x), basis=None, col_values=None)
            return (sol, st) if return_stats else sol
        prog = res.prog  # no reductions: fall through (names unchanged)

    int_vars = {name: v for name, v in prog.vars.items() if v.isint}
    stats = BnbStats()
    if not int_vars:
        from ..solve.api import solve_lp

        sol = solve_lp(prog, options=options, dtype=dtype, refine="exact",
                       device=dev)
        return (sol, stats) if return_stats else sol

    if mesh is not None:
        if node_encoding != "rows":
            raise ValueError("mesh MILP solving supports node_encoding="
                             "'rows' only")
        bsz = mesh_axis_size(mesh, batch_axis)
        if batch_size % bsz:
            raise ValueError(
                f"batch_size ({batch_size}) must be a multiple of the "
                f"'{batch_axis}' mesh axis size ({bsz})")
    if node_encoding == "spans":
        # bound-vector node encoding over the batched bounded driver: no
        # bound rows in any node tableau; cold waves (a documented mode of
        # tpulp's, measured slower than 'rows' there)
        if checkpoint_path is not None or resume_from is not None:
            raise ValueError("node_encoding='spans' does not support "
                             "checkpoint/resume yet; use 'rows'")
        if time_limit is not None or gap_tol > 0.0:
            raise ValueError("node_encoding='spans' does not support "
                             "time_limit/gap_tol; use 'rows'")
        from .spans import solve_milp_spans

        return solve_milp_spans(
            prog, options=options, dtype=dtype, batch_size=batch_size,
            max_nodes=max_nodes, refine=refine, int_tol=int_tol,
            return_stats=return_stats, device=dev)
    if node_encoding != "rows":
        raise ValueError(f"unknown node_encoding {node_encoding!r}")

    root_sf = lower_to_standard_form(prog, integer_bound_rows=True)
    if root_sf.trivially_infeasible:
        sol = Solution(status="infeasible")
        return (sol, stats) if return_stats else sol

    if refine == "auto":
        refine = "exact" if root_sf.m <= exact_max_m else "float64"
    if refine not in ("exact", "float64"):
        raise ValueError(f"unknown refine mode {refine!r}")
    exact_mode = refine == "exact"

    if branching not in ("most_fractional", "pseudocost"):
        raise ValueError(f"unknown branching rule {branching!r}")
    pc = _Pseudocosts() if branching == "pseudocost" else None

    root_bounds: Bounds = {}
    for name, v in int_vars.items():
        if name not in root_sf.int_bound_rows:
            continue  # fixed var: nothing to branch on
        root_bounds[name] = (v.lb, v.ub)
    branch_names = list(root_bounds)

    # generation chaining: float bounding, most-fractional branching, and
    # branch values exact in f32 (bounds within +-2^20)
    gen_ok = (device_generations > 1 and not exact_mode and pc is None
              and bool(branch_names)
              and all(abs(lb) <= 2**20 and abs(ub) <= 2**20
                      for lb, ub in root_bounds.values()))
    gen_meta = None  # (le_col, le_sign, ge_col, ge_sign) device tensors

    # frontier entries: (parent bound as float, tiebreak, exact bound,
    # bounds, warm_ref, pseudocost tag, checkpointed parent basis).
    # ``warm_ref = (slot, col, delta)`` names the parent's terminal frame in
    # the state pool: the child is ``T[:, -1] += delta * T[:, col]`` in the
    # parent's basis frame, re-optimized by the dual simplex. None means a
    # cold two-phase solve (root, resumed nodes, children of solo-resolved
    # lanes, pool overflow).
    counter = itertools.count()
    frontier: List[Tuple] = []
    incumbent: Optional[Solution] = None
    incumbent_z: Optional[Fraction] = None  # minimization value, EXACT

    if resume_from is not None:
        from ..io.checkpoint import load_bnb_frontier

        loaded, incumbent_z, ck_meta = load_bnb_frontier(resume_from)
        # the checkpoint was written in THIS solve's variable space (after
        # any presolve reductions): a mismatch means another program or
        # presolve setting
        ck_vars = ck_meta.get("branch_vars")
        if ck_vars is not None and sorted(ck_vars) != sorted(branch_names):
            raise ValueError(
                "checkpoint branch variables do not match this program's "
                f"(checkpoint: {sorted(ck_vars)}, program: "
                f"{sorted(branch_names)}); resume with the same program and "
                "presolve setting that wrote the checkpoint")
        counter = itertools.count(
            start=1 + max((tb for _, tb, _, _ in loaded), default=0))
        for bound, tb, bounds, _pbasis in loaded:
            # nodes checkpointed with a parent basis warm-start from the
            # resumed first wave (frame reconstruction + dual simplex)
            pb = None
            if _pbasis is not None and len(_pbasis) == root_sf.m:
                pb = np.asarray(_pbasis, dtype=np.int32)
            heapq.heappush(frontier,
                           (float(bound), tb, bound, bounds, None, None,
                            pb))
        inc = ck_meta.get("incumbent")
        if inc is not None:
            incumbent = Solution(
                status="optimal",
                objective=Fraction(inc["objective"]),
                x={k: Fraction(v) for k, v in inc["x"].items()},
                objective_min=Fraction(inc["objective_min"]))
    else:
        heapq.heappush(
            frontier,
            (-1e18, next(counter), Fraction(-10**18), root_bounds, None,
             None, None))

    def _checkpoint():
        from ..io.checkpoint import save_bnb_frontier

        meta = {"nodes_solved": stats.nodes_solved,
                "branch_vars": sorted(branch_names)}
        if incumbent is not None:
            meta["incumbent"] = {
                "objective": str(Fraction(incumbent.objective)),
                "objective_min": str(Fraction(incumbent.objective_min)),
                "x": {k: str(Fraction(v)) for k, v in incumbent.x.items()},
            }
        # each warm node's PARENT basis (one pool fetch per checkpoint): a
        # resumed run rebuilds the parent frame and re-optimizes warm
        pool_np = None
        entries = []
        for _, tb, bound, bounds, ref, _pc, pb in frontier:
            basis_out = None if pb is None else pb
            if ref is not None:
                if pool_np is None:
                    pool_np = pool_basis[:pool_cap].cpu().numpy()
                basis_out = pool_np[ref[0]]
            entries.append((bound, tb, bounds, basis_out))
        save_bnb_frontier(checkpoint_path, entries, incumbent_z, meta=meta)
    root_unbounded = False
    R_dev = const_dev = None  # device recover map for the integrality check
    template = art_row_mask = None  # device-resident batched wave template
    root_T = root_masks = None  # the template's first lane, full width
    # the wave engines: the solo ones, or a mesh's (chosen with the
    # template)
    cold_wave, warm_batch, warm_wave, expand_generation = (
        run_simplex_batch, run_warm_batch, run_warm_wave,
        run_expand_generation)
    waves = None
    deferred = None   # (out, slots, lanes): pool writes riding the next wave
    last_out = None   # previous wave's terminal state (deferred-write source)
    warm_masks = None  # (col_active, art_cols) phase-2 masks of the root
    art_cols_host = None  # cached host copy (identical every wave)
    art_start_batched = 0  # first artificial column in batched space

    def _remap_basis_col(j: int, sf_n: int) -> int:
        """Batched column space -> sf space (artificials at sf.n + k)."""
        return j if j < sf_n else sf_n + (j - art_start_batched)

    # ---- device state pool (parent terminal frames for warm starts) -------
    pool_T = pool_basis = None
    pool_cap = 0
    free_slots: List[int] = []
    slot_refs: Dict[int, int] = {}

    def _pool_init():
        nonlocal pool_T, pool_basis, pool_cap, free_slots
        bytes_per = ((root_sf.m + 2)
                     * (root_T.shape[1]) * template.T.element_size())
        pool_cap = int(min(POOL_CAP_MAX, max(4 * batch_size, 64),
                           max(64, 512_000_000 // max(bytes_per, 1))))
        pool_T, pool_basis = new_pool(pool_cap, template.T.shape[1:],
                                      root_sf.m, template.T.dtype, dev)
        stats.pool_bytes = sum(x.numel() * x.element_size()
                               for x in (pool_T, pool_basis))
        free_slots = list(range(pool_cap))

    def _slot_release(slot: int):
        slot_refs[slot] -= 1
        if slot_refs[slot] == 0:
            del slot_refs[slot]
            free_slots.append(slot)

    def _pool_check():
        """Audit the slot-accounting invariants (POOL_DEBUG only): no slot
        both free and referenced, no duplicate or out-of-range free slot,
        and every refcount equal to the frontier entries naming it."""
        free = list(free_slots)
        assert len(free) == len(set(free)), "duplicate free slot"
        assert all(0 <= s < pool_cap for s in free), "out-of-range free slot"
        assert not (set(free) & set(slot_refs)), (
            "slot both free and referenced", free, dict(slot_refs))
        assert all(cnt > 0 for cnt in slot_refs.values()), dict(slot_refs)
        claimed: Dict[int, int] = {}
        for entry in frontier:
            ref = entry[4]
            if ref is not None:
                claimed[ref[0]] = claimed.get(ref[0], 0) + 1
        assert claimed == dict(slot_refs), (
            "refcounts drifted from frontier claims", claimed,
            dict(slot_refs))

    def _flush(out, slots, lanes):
        """One fixed-width pool write of ``out``'s lanes into ``slots``
        (unused positions padded with the dropped slot ``pool_cap``)."""
        s_arr = np.full((batch_size,), pool_cap, np.int32)
        l_arr = np.zeros((batch_size,), np.int32)
        s_arr[:len(slots)] = slots
        l_arr[:len(lanes)] = lanes
        pool_write(pool_T, pool_basis, s_arr, out.T, out.basis, l_arr)

    # per-row slack/surplus column + sign: the sparse child-RHS rewrite uses
    # row i's slack column (+1, original column e_i) or surplus (-1, -e_i)
    row_adj: Dict[int, Tuple[int, int]] = {}
    for j, nm in enumerate(root_sf.col_names):
        if j < root_sf.n_struct:
            continue  # structural columns; user names may mimic _s/_e
        if nm.startswith("_s"):
            row_adj[int(nm[2:])] = (j, 1)
        elif nm.startswith("_e"):
            row_adj[int(nm[2:])] = (j, -1)

    _is_f32 = _torch_dtype(dtype) == torch.float32

    def prune_margin() -> float:
        """Safety margin for float-mode pruning, scaled to the iterate
        precision: a larger margin only explores more, never prunes
        wrongly; incumbents are exact-verified regardless."""
        if exact_mode or incumbent_z is None:
            return 0.0
        eps = 3e-5 if _is_f32 else 1e-7
        return eps * (1.0 + abs(float(incumbent_z)))

    # integral-objective bound rounding: when every objective term is an
    # integer coefficient on an integer variable (and the constant is
    # integral), every feasible point has an integral objective, so a
    # node's float bound rounds up before the prune test
    def _objective_is_integral() -> bool:
        try:
            terms = prog.objective.expr.terms()
            if Fraction(prog.objective.expr.getConstant()
                        ).denominator != 1:
                return False
            for nm, cf in terms.items():
                v = prog.getVariable(nm)
                if v is None or not v.isint:
                    return False
                if Fraction(cf).denominator != 1:
                    return False
            return True
        except Exception:
            return False

    obj_integral = _objective_is_integral()

    def cannot_improve(bound) -> bool:
        if incumbent_z is None:
            return False
        if exact_mode:
            return bound >= incumbent_z
        if obj_integral:
            b_eff = math.ceil(float(bound) - prune_margin() - 1e-9)
            return b_eff >= incumbent_z
        return float(bound) >= float(incumbent_z) + prune_margin()

    def exact_incumbent_check(node_sf: StandardForm, basis
                              ) -> Tuple[Optional[Solution], Dict[str, Fraction]]:
        """Exact verification of a candidate incumbent basis: returns
        (Solution, {}) if truly integral, else (None, exact int values)."""
        col_values, z_min = exact_basis_solve(node_sf, basis)
        xc = [col_values.get(j, Fraction(0)) for j in range(node_sf.n)]
        x = node_sf.recover_solution(xc)
        fractional = {name: x[name] for name in branch_names
                      if Fraction(x[name]).denominator != 1}
        if fractional:
            return None, {name: Fraction(x[name]) for name in branch_names}
        obj = node_sf.objective_value(xc)
        return Solution(status="optimal", objective=obj, x=x,
                        objective_min=z_min,
                        col_values=dict(col_values), basis=list(basis)), {}

    def _chain_wave(wave, sub) -> None:
        """The device-side generation chain for one sub-wave: up to
        ``device_generations - 1`` expansions from the solved sub-wave, ONE
        read of the whole chain's summaries, then the host reconciliation:
        exact incumbent verification, pruning against the exact incumbent,
        frontier pushes (final-generation children warm from pool-parked
        frames; overflow-dropped children re-queued cold)."""
        nonlocal incumbent, incumbent_z, last_out, deferred, root_unbounded

        idxs0, out0, _is_warm0, summ0 = sub
        if deferred is not None:
            # an older deferral no warm wave consumed: flush it before the
            # chain writes
            _flush(*deferred)
            deferred = None
        B = batch_size
        n_int = len(branch_names)
        _ta0 = time.perf_counter()
        lbm = np.zeros((B, n_int), np.float64)
        ubm = np.zeros((B, n_int), np.float64)
        for lane, k in enumerate(idxs0):
            bd = wave[k][1]
            for jj, nm in enumerate(branch_names):
                lb, ub = bd.get(nm, root_bounds[nm])
                lbm[lane, jj] = float(lb)
                ubm[lane, jj] = float(ub)
        active0 = np.zeros((B,), bool)
        active0[:len(idxs0)] = True
        # prune threshold on the tableau CORNER (-z_rel), from the exact
        # incumbent at chain start; with an integral objective it tightens
        # by ~1. The host re-checks every node with cannot_improve.
        if incumbent_z is None:
            cut = -np.inf
        else:
            thr = float(incumbent_z) + prune_margin()
            if obj_integral:
                thr = float(incumbent_z) - 1.0 + prune_margin() + 1e-6
            cut = float(root_sf.obj_const) - thr
        gdt = template.T.dtype
        le_c, le_s, ge_c, ge_s = gen_meta
        Ws = summ0.shape[1]
        summs = [torch.cat([summ0, torch.full((B, 2), -1.0, dtype=gdt,
                                              device=dev)], dim=1)]
        gen_states = [out0]
        expands = []
        cur_T, cur_b, cur_summ = out0.T, out0.basis, summ0
        cur_act = torch.as_tensor(active0, device=dev)
        cur_lb = torch.as_tensor(lbm, dtype=gdt, device=dev)
        cur_ub = torch.as_tensor(ubm, dtype=gdt, device=dev)
        cut_dev = torch.tensor(cut, dtype=gdt, device=dev)
        tol_dev = torch.tensor(int_tol, dtype=gdt, device=dev)
        _tg0 = time.perf_counter()
        for _g in range(device_generations - 1):
            outg, summg, actg, lbg, ubg, eg = expand_generation(
                cur_T, cur_b, cur_summ, cur_act, cur_lb, cur_ub,
                warm_masks[0], warm_masks[1], le_c, le_s, ge_c, ge_s,
                cut_dev, tol_dev, options.max_iters, R_dev, const_dev,
                opts=options)
            gen_states.append(outg)
            summs.append(summg)
            expands.append(eg)
            cur_T, cur_b, cur_act, cur_lb, cur_ub = (
                outg.T, outg.basis, actg, lbg, ubg)
            cur_summ = summg[:, :Ws]
        stats.gen_waves += len(expands)
        _tf0 = time.perf_counter()
        stats.t_assemble += _tg0 - _ta0
        # ONE flat read for the whole chain (summaries + expansion masks)
        summ_stack = torch.stack(summs)
        Gn = len(summs)
        W2 = summ_stack.shape[2]
        parts = [summ_stack.reshape(-1)]
        if expands:
            parts.append(torch.stack(expands).reshape(-1).to(gdt))
        buf = torch.cat(parts).cpu().numpy()
        summ_all = buf[:Gn * B * W2].reshape(Gn, B, W2)
        e_all = buf[Gn * B * W2:].reshape(len(expands), B).astype(np.int32) \
            if expands else np.zeros((0, B), np.int32)
        _tp1 = time.perf_counter()
        stats.t_device += _tp1 - _tg0

        G = len(summs)
        m_r = root_sf.m
        # genealogy index per generation: child lane -> (parent, is_up)
        kids_of: List[Dict[int, List[Tuple[int, int]]]] = []
        for g in range(G):
            km: Dict[int, List[Tuple[int, int]]] = {}
            if g > 0:
                pa = summ_all[g][:, Ws].astype(np.int64)
                iu = summ_all[g][:, Ws + 1].astype(np.int64)
                n_real = int((pa >= 0).sum())
                stats.nodes_solved += n_real
                stats.gen_nodes += n_real
                stats.warm_nodes += n_real
                for cl in range(B):
                    if pa[cl] >= 0:
                        km.setdefault(int(pa[cl]), []).append(
                            (cl, int(iu[cl])))
            kids_of.append(km)

        pool_pending: List[Tuple[int, int, int]] = []  # (gen, lane, slot)

        def _push_cold(child_bounds, zf, z):
            heapq.heappush(frontier, (zf, next(counter), z, child_bounds,
                                      None, None, None))

        def _push_warm(bounds_g, frac_name, lo, zf, z, gen_idx, lane):
            lb, ub = bounds_g.get(frac_name, root_bounds[frac_name])
            hi = lo + 1
            le_row, ge_row = root_sf.int_bound_rows[frac_name]
            slot = free_slots.pop() if free_slots else None
            warm_children = 0
            for child_lb, child_ub in ((lb, lo), (hi, ub)):
                if child_lb > child_ub:
                    continue
                child = dict(bounds_g)
                child[frac_name] = (child_lb, child_ub)
                warm_ref = None
                if slot is not None:
                    if child_ub != ub:
                        row_, delta_b = le_row, child_ub - ub
                    else:
                        row_, delta_b = ge_row, child_lb - lb
                    adj = row_adj.get(row_)
                    if (adj is not None and delta_b.denominator == 1
                            and abs(delta_b) < 2 ** 31):
                        col, sign = adj
                        warm_ref = (slot, col, int(sign * delta_b))
                        warm_children += 1
                heapq.heappush(frontier, (zf, next(counter), z, child,
                                          warm_ref, None, None))
            if slot is not None:
                if warm_children:
                    slot_refs[slot] = warm_children
                    pool_pending.append((gen_idx, lane, slot))
                else:
                    free_slots.append(slot)

        nodes: Dict[int, Bounds] = {
            lane: dict(wave[k][1]) for lane, k in enumerate(idxs0)}
        for g in range(G):
            S = summ_all[g]
            if g > 0:
                stats.warm_pivots += int(
                    S[:, 4][summ_all[g][:, Ws] >= 0].sum())
            nxt: Dict[int, Bounds] = {}
            for lane in sorted(nodes):
                bounds_g = nodes[lane]
                row = S[lane]
                status = Status.NAMES.get(int(row[3]), "unknown")
                niter = int(row[4])
                if status in ("numerical_error", "iteration_limit"):
                    # untrusted lane: solo exact re-solve; device-built
                    # children of it are not visited (its own cold
                    # children replace them)
                    stats.solo_resolves += 1
                    sf_node = _node_standard_form(root_sf, bounds_g)
                    sol = solve_standard_form(sf_node, options=options,
                                              dtype=dtype, refine="exact",
                                              device=dev)
                    if sol.status == "infeasible":
                        stats.nodes_pruned_infeasible += 1
                        continue
                    if sol.status == "unbounded":
                        root_unbounded = True
                        frontier.clear()
                        return
                    if sol.status != "optimal":
                        continue
                    z = sol.objective_min
                    if cannot_improve(z):
                        stats.nodes_pruned_bound += 1
                        continue
                    verified, exact_vals = exact_incumbent_check(
                        sf_node, sol.basis)
                    if verified is not None:
                        if incumbent_z is None or \
                                verified.objective_min < incumbent_z:
                            incumbent = dataclasses.replace(
                                verified, niter=sol.niter)
                            incumbent_z = verified.objective_min
                            stats.incumbent_updates += 1
                        continue
                    fr = {n2: v for n2, v in exact_vals.items()
                          if v.denominator != 1}
                    fn2 = _most_fractional(fr)
                    val = exact_vals[fn2]
                    lbv, ubv = bounds_g.get(fn2, root_bounds[fn2])
                    lo = Fraction(math.floor(val))
                    zf = float(z)
                    for child_lb, child_ub in ((lbv, lo), (lo + 1, ubv)):
                        if child_lb > child_ub:
                            continue
                        child = dict(bounds_g)
                        child[fn2] = (child_lb, child_ub)
                        _push_cold(child, zf, z)
                    continue
                if status == "infeasible":
                    stats.nodes_pruned_infeasible += 1
                    continue
                if status == "unbounded":
                    root_unbounded = True
                    frontier.clear()
                    return
                if status != "optimal":
                    continue
                zf = float(-row[0]) + float(root_sf.obj_const)
                z = Fraction(zf).limit_denominator(10 ** 12)
                if cannot_improve(z):
                    stats.nodes_pruned_bound += 1
                    continue
                maxdist = float(row[1])
                if maxdist <= int_tol:
                    basis = [_remap_basis_col(int(v2), root_sf.n)
                             for v2 in row[6:6 + m_r].astype(np.int64)]
                    sf_node = _node_standard_form(root_sf, bounds_g)
                    _tv0 = time.perf_counter()
                    try:
                        verified, exact_vals = exact_incumbent_check(
                            sf_node, basis)
                    except (ZeroDivisionError, np.linalg.LinAlgError):
                        stats.solo_resolves += 1
                        sol2 = solve_standard_form(
                            sf_node, options=options, dtype=dtype,
                            refine="exact", device=dev)
                        if sol2.status != "optimal":
                            stats.t_verify += time.perf_counter() - _tv0
                            continue
                        verified, exact_vals = exact_incumbent_check(
                            sf_node, sol2.basis)
                    stats.t_verify += time.perf_counter() - _tv0
                    if verified is not None:
                        z_exact = verified.objective_min
                        if incumbent_z is None or z_exact < incumbent_z:
                            incumbent = dataclasses.replace(
                                verified, niter=niter)
                            incumbent_z = z_exact
                            stats.incumbent_updates += 1
                        continue
                    # exactly fractional after all: branch on exact values
                    fr = {n2: v for n2, v in exact_vals.items()
                          if v.denominator != 1}
                    fn2 = _most_fractional(fr)
                    val = exact_vals[fn2]
                    lbv, ubv = bounds_g.get(fn2, root_bounds[fn2])
                    lo = Fraction(math.floor(val))
                    for child_lb, child_ub in ((lbv, lo), (lo + 1, ubv)):
                        if child_lb > child_ub:
                            continue
                        child = dict(bounds_g)
                        child[fn2] = (child_lb, child_ub)
                        _push_cold(child, zf, z)
                    continue
                # fractional node
                v_idx = int(row[5])
                frac_name = branch_names[v_idx]
                f = Fraction(math.floor(float(row[2])))
                expanded = g < G - 1 and bool(e_all[g][lane])
                if expanded:
                    kids = kids_of[g + 1].get(lane, [])
                    have = set()
                    lbv, ubv = bounds_g.get(frac_name,
                                            root_bounds[frac_name])
                    for cl, up in kids:
                        have.add(up)
                        child = dict(bounds_g)
                        child[frac_name] = (f + 1, ubv) if up else (lbv, f)
                        nxt[cl] = child
                    for up in (0, 1):
                        if up not in have:
                            # overflow-dropped child: re-queue cold
                            child = dict(bounds_g)
                            child[frac_name] = (f + 1, ubv) if up \
                                else (lbv, f)
                            if child[frac_name][0] <= child[frac_name][1]:
                                _push_cold(child, zf, z)
                else:
                    # last generation (or the device declined under a
                    # stale cut): branch on the host from a pool-parked
                    # warm frame
                    _push_warm(bounds_g, frac_name, f, zf, z, g, lane)
            nodes = nxt

        # park the branched final-generation frames in the pool, one
        # fixed-width write per generation state
        groups: Dict[int, Tuple[List[int], List[int]]] = {}
        for gen_idx, lane, slot in pool_pending:
            slots, lanes = groups.setdefault(gen_idx, ([], []))
            slots.append(slot)
            lanes.append(lane)
        for gen_idx, (slots, lanes) in groups.items():
            _flush(gen_states[gen_idx], slots, lanes)
        last_out = gen_states[-1]
        stats.t_process += time.perf_counter() - _tp1

    stop_reason: Optional[str] = None
    while frontier and stats.nodes_solved < max_nodes:
        if time_limit is not None and _agree(
                time.perf_counter() - _t_solve0 >= time_limit):
            stop_reason = "time_limit"
            break
        if gap_tol > 0.0 and incumbent is not None:
            best_open = min(zf for zf, *_ in frontier)
            inc_f = float(incumbent_z)
            if max(0.0, (inc_f - best_open) / max(abs(inc_f), 1.0)) \
                    <= gap_tol:
                stop_reason = "gap_limit"
                break
        _tw0 = time.perf_counter()
        wave: List[Tuple] = []
        while frontier and len(wave) < batch_size:
            (_, _, bound, bounds, warm_ref, pc_tag,
             pbasis) = heapq.heappop(frontier)
            if warm_ref is not None:
                # this child's claim on its parent's slot ends here; a slot
                # freed now may be rewritten in this cycle, after the wave
                # has gathered from it (the gathers are copies, and the
                # device runs the writes after them)
                _slot_release(warm_ref[0])
            # prune by parent bound against current incumbent
            if cannot_improve(bound):
                stats.nodes_pruned_bound += 1
                continue
            wave.append((bound, bounds, warm_ref, pc_tag, pbasis))
        if not wave:
            break

        sfs = [_node_standard_form(root_sf, bounds)
               for _, bounds, *_ in wave]
        # device-resident template: nodes differ from the root ONLY in b,
        # so a cold wave uploads just the (B, m) RHS matrix
        if template is None:
            template, art_cols_host = make_batched_states(
                [sfs[0]] * batch_size, dtype=dtype, return_host_art=True,
                device=dev)
            if mesh is not None:
                # the mesh waves: the template padded to the cols axis (as
                # tpulp pads it) and split into this shard's frames, once;
                # the refreshes, waves and pool inherit that layout
                from ..shard.sharded_waves import MeshWaves

                template = pad_batched_columns(
                    template, mesh_axis_size(mesh, cols_axis))
                art_cols_host = template.art_cols.cpu().numpy()
                waves = MeshWaves(mesh, template.T.shape[2] - 1,
                                  batch_axis, cols_axis)
                cold_wave, warm_batch, warm_wave, expand_generation = (
                    waves.cold_wave, waves.run_warm_batch,
                    waves.run_warm_wave, waves.run_expand_generation)
            art_row_mask = torch.tensor(
                [1.0 if h < 0 else 0.0 for h in root_sf.basis_hint],
                dtype=template.T.dtype, device=dev)
            art0 = template.art_cols[0]
            root_T = template.T[0].clone()
            root_masks = (template.col_active[0] & ~art0, art0)
            warm_masks = root_masks
            if waves is not None:
                warm_masks = tuple(waves.block(x) for x in root_masks)
                template = waves.to_frames(template)
            art_start_batched = int(art_cols_host[0].argmax()) \
                if art_cols_host[0].any() else art_cols_host.shape[1]
            _pool_init()
            np_dtype = np.float32 if template.T.dtype == torch.float32 \
                else np.float64
            n_batched = root_T.shape[1] - 1
            if branch_names:
                R_np, const_np = _int_recover_matrix(
                    root_sf, branch_names, n_batched, np_dtype)
            else:  # no integer vars to check: harmless 1-row placeholder
                R_np = np.zeros((1, n_batched), dtype=np_dtype)
                const_np = np.zeros((1,), dtype=np_dtype)
            R_dev = torch.as_tensor(R_np, device=dev)
            const_dev = torch.as_tensor(const_np, device=dev)
            if gen_ok:
                # per-branch-var rewrite metadata for device-built children:
                # the bound rows' slack/surplus columns and signs
                _lec, _les, _gec, _ges = [], [], [], []
                for nm in branch_names:
                    le_row, ge_row = root_sf.int_bound_rows[nm]
                    a1 = row_adj.get(le_row)
                    a2 = row_adj.get(ge_row)
                    if a1 is None or a2 is None:
                        gen_ok = False
                        break
                    _lec.append(a1[0])
                    _les.append(float(a1[1]))
                    _gec.append(a2[0])
                    _ges.append(float(a2[1]))
                if gen_ok:
                    _gdt = template.T.dtype
                    gen_meta = (
                        torch.tensor(_lec, dtype=torch.long, device=dev),
                        torch.tensor(_les, dtype=_gdt, device=dev),
                        torch.tensor(_gec, dtype=torch.long, device=dev),
                        torch.tensor(_ges, dtype=_gdt, device=dev))
        n_wave = len(wave)
        m_rows = root_sf.m
        ck_idx = [k for k in range(n_wave)
                  if wave[k][2] is None and wave[k][4] is not None]
        cold_idx = [k for k in range(n_wave)
                    if wave[k][2] is None and wave[k][4] is None]
        warm_idx = [k for k in range(n_wave) if wave[k][2] is not None]

        # each sub-wave returns ONE packed summary (one read per sub-wave)
        outs = []  # (wave indices, out_state, is_warm, summary)
        t_eng = 0.0  # engine time inside this wave's dispatch section
        if cold_idx:
            b_mat = np.empty((batch_size, m_rows), dtype=np.float64)
            for lane, k in enumerate(cold_idx):
                b_mat[lane] = [float(v) for v in sfs[k].b]
            b_mat[len(cold_idx):] = b_mat[0]
            _te0 = time.perf_counter()
            batched = _refresh_template(
                template, torch.as_tensor(b_mat, dtype=template.T.dtype,
                                          device=dev), art_row_mask)
            cout = cold_wave(batched, options)
            outs.append((cold_idx, cout, False,
                         pack_wave_summary(cout, R_dev, const_dev)))
            t_eng += time.perf_counter() - _te0
        if ck_idx:
            # resumed nodes with a checkpointed parent basis: rebuild the
            # parent frame from (basis, b) and re-optimize with the dual
            # simplex
            basis_mat = np.zeros((len(ck_idx), m_rows), np.int32)
            b_ck = np.zeros((len(ck_idx), m_rows), np.float64)
            for lane, k in enumerate(ck_idx):
                basis_mat[lane] = wave[k][4]
                b_ck[lane] = [float(v) for v in sfs[k].b]
            _te0 = time.perf_counter()
            ckout = warm_batch(
                root_T[2:, :-1], root_T[0, :-1], *root_masks, basis_mat,
                torch.as_tensor(b_ck, dtype=template.T.dtype, device=dev),
                options)
            outs.append((ck_idx, ckout, True,
                         pack_wave_summary(ckout, R_dev, const_dev)))
            t_eng += time.perf_counter() - _te0
            stats.warm_nodes += len(ck_idx)
        if warm_idx:
            # ONE (B, 5) int32 upload: [parent slot, rewrite col, deferred
            # write slot, deferred write lane, integral rhs delta]
            ipack = np.zeros((batch_size, 5), np.int32)
            ipack[:, 2] = pool_cap          # default: dropped write
            for lane, k in enumerate(warm_idx):
                slot, col, delta = wave[k][2]
                ipack[lane, 0] = slot
                ipack[lane, 1] = col
                ipack[lane, 4] = delta
            ipack[len(warm_idx):, 0] = ipack[0, 0]  # padded: repeat lane 0
            ipack[len(warm_idx):, 1] = ipack[0, 1]
            ipack[len(warm_idx):, 4] = ipack[0, 4]
            # the previous wave's branched frames ride into the pool inside
            # this wave (deferred writes)
            if deferred is not None:
                prev_out, wslots, wlanes = deferred
            else:
                prev_out, wslots, wlanes = last_out, [], []
            ipack[:len(wslots), 2] = wslots
            ipack[:len(wlanes), 3] = wlanes
            deferred = None
            _te0 = time.perf_counter()
            pool_T, pool_basis, wout, summ_w = warm_wave(
                pool_T, pool_basis, *warm_masks,
                prev_out.T, prev_out.basis, ipack,
                R_dev, const_dev, options.max_iters, options)
            t_eng += time.perf_counter() - _te0
            outs.append((warm_idx, wout, True, summ_w))
            stats.warm_nodes += len(warm_idx)
        stats.nodes_solved += n_wave
        stats.waves += 1
        _td0 = time.perf_counter()
        stats.t_assemble += _td0 - _tw0 - t_eng
        stats.t_device += t_eng
        if gen_ok and gen_meta is not None and outs and not ck_idx:
            # device-side generation chain: each sub-wave (their lanes
            # partition the wave) expands and reconciles on its own; resume
            # (ck) sub-waves fall back to the single-generation processing
            for _sub in outs:
                if root_unbounded:
                    break  # frontier was cleared; nothing may repopulate it
                _chain_wave(wave, _sub)
            if POOL_DEBUG:
                _pool_check()
            if checkpoint_path is not None and \
                    stats.waves % max(checkpoint_every, 1) == 0:
                _checkpoint()
            continue
        outs = [(idxs, out, w, summ.cpu().numpy())
                for idxs, out, w, summ in outs]
        _tp0 = time.perf_counter()
        stats.t_device += _tp0 - _td0

        # ---- merge sub-wave results + device integrality check ------------
        sols: List[Optional[Solution]] = [None] * n_wave
        maxdist = np.zeros(n_wave) if branch_names else None
        intvals = (np.zeros((n_wave, len(branch_names)))
                   if branch_names else None)
        argmax = np.zeros(n_wave, dtype=np.int64) if branch_names else None
        branchval = np.zeros(n_wave) if branch_names else None
        state_ref: List[Optional[Tuple]] = [None] * n_wave
        pending_writes: List[Tuple[Tuple, int]] = []  # ((out, lane), slot)
        for idxs, out, is_warm, summ in outs:
            # [corner, maxdist, branch-value, status, niter, argmax,
            # basis..., int values...]; int fields are exact in the dtype
            corners = summ[:, 0]
            md = summ[:, 1]
            bval = summ[:, 2]
            statuses = summ[:, 3].astype(np.int32)
            niters = summ[:, 4].astype(np.int32)
            am = summ[:, 5].astype(np.int32)
            braw = summ[:, 6:6 + m_rows].astype(np.int32)
            ivals = summ[:, 6 + m_rows:]
            if is_warm:
                stats.warm_pivots += int(niters[:len(idxs)].sum())
            if exact_mode:
                # exact bounds: per-lane exact refinement
                sub = extract_batch_solutions(
                    [sfs[i] for i in idxs], out, refine,
                    prefetched=(statuses, niters, braw, corners,
                                art_cols_host))
            else:
                # float64 bounding: the summary IS the per-node result
                # (bound from the tableau corner with the pruning margin;
                # incumbent candidates get the exact check below)
                sub = []
                for lane, i in enumerate(idxs):
                    status = Status.NAMES.get(int(statuses[lane]), "unknown")
                    if status != "optimal":
                        sub.append(Solution(status=status,
                                            niter=int(niters[lane])))
                        continue
                    zmin = float(-corners[lane]) + float(sfs[i].obj_const)
                    basis = [_remap_basis_col(int(j), sfs[i].n)
                             for j in braw[lane][:m_rows]]
                    sub.append(Solution(
                        status="optimal", objective_min=zmin,
                        basis=basis, niter=int(niters[lane])))
            for lane, i in enumerate(idxs):
                sols[i] = sub[lane]
                if branch_names:
                    maxdist[i] = md[lane]
                    argmax[i] = am[lane]
                    branchval[i] = bval[lane]
                    if ivals.shape[1] >= len(branch_names):
                        intvals[i] = ivals[lane][:len(branch_names)]
                state_ref[i] = (out, lane)

        for k, ((parent_bound, bounds, _, pc_tag, _pb),
                sol) in enumerate(zip(wave, sols)):
            if sol.status in ("numerical_error", "iteration_limit"):
                # a failed lane may hold the optimum: re-solve it solo
                # through the full precision ladder; its children re-solve
                # cold, and integrality comes from the exact x
                stats.solo_resolves += 1
                sol = solve_standard_form(
                    sfs[k], options=options, dtype=dtype, refine="exact",
                    device=dev)
                state_ref[k] = None
                if sol.status == "optimal" and branch_names:
                    dists = [
                        abs(v - round(v))
                        for v in (float(sol.x[nm]) for nm in branch_names)]
                    maxdist[k] = max(dists)
                    argmax[k] = int(np.argmax(dists))
            if sol.status == "infeasible":
                stats.nodes_pruned_infeasible += 1
                continue
            if sol.status == "unbounded":
                # with integer bound rows, unboundedness comes from the
                # continuous part: the MILP is unbounded if any node is
                root_unbounded = True
                frontier.clear()
                break
            if sol.status != "optimal":
                continue
            z = sol.objective_min  # exact Fraction iff exact_mode
            if pc is not None and pc_tag is not None:
                # learn from every solved child, pruned ones included
                var, direction, dist = pc_tag
                pc.record(var, direction,
                          float(z) - float(parent_bound), dist)
            if cannot_improve(z):
                stats.nodes_pruned_bound += 1
                continue

            looks_integral = (
                not branch_names or float(maxdist[k]) <= int_tol)
            if looks_integral:
                # candidate incumbent: ALWAYS verify exactly
                _tv0 = time.perf_counter()
                try:
                    verified, exact_vals = exact_incumbent_check(
                        sfs[k], sol.basis)
                except (ZeroDivisionError, np.linalg.LinAlgError):
                    stats.solo_resolves += 1
                    sol2 = solve_standard_form(
                        sfs[k], options=options, dtype=dtype, refine="exact",
                        device=dev)
                    if sol2.status != "optimal":
                        continue
                    verified, exact_vals = exact_incumbent_check(
                        sfs[k], sol2.basis)
                stats.t_verify += time.perf_counter() - _tv0
                if verified is not None:
                    z_exact = verified.objective_min
                    if incumbent_z is None or z_exact < incumbent_z:
                        incumbent = dataclasses.replace(
                            verified, niter=sol.niter)
                        incumbent_z = z_exact
                        stats.incumbent_updates += 1
                    continue
                # exactly fractional after all: branch on the exact values
                fr = {n: v for n, v in exact_vals.items()
                      if v.denominator != 1}
                frac_name = pc.select(fr) if pc is not None \
                    else _most_fractional(fr)
                val = exact_vals[frac_name]
            else:
                frac_name = None
                if pc is not None:
                    if sol.x is not None:   # exact mode or solo re-solve
                        fr = {nm: Fraction(sol.x[nm]) for nm in branch_names
                              if Fraction(sol.x[nm]).denominator != 1}
                    else:  # float64 waves: the summary's value vector
                        fr = {}
                        for jj, nm in enumerate(branch_names):
                            v = float(intvals[k][jj])
                            if abs(v - round(v)) > int_tol:
                                fr[nm] = Fraction(v).limit_denominator(10**9)
                    if fr:
                        frac_name = pc.select(fr)
                if frac_name is None:
                    frac_name = branch_names[int(argmax[k])]
                if exact_mode:
                    val = Fraction(sol.x[frac_name])
                elif sol.x is not None:  # solo-resolved lane: exact x
                    val = Fraction(
                        float(sol.x[frac_name])).limit_denominator(10**9)
                else:  # device-computed branch value from the wave summary
                    bf = (float(intvals[k][branch_names.index(frac_name)])
                          if frac_name != branch_names[int(argmax[k])]
                          else float(branchval[k]))
                    val = None
                    if abs(bf) > EXACT_BRANCH_ABOVE and sol.basis is not None:
                        # above this, limit_denominator could misplace the
                        # split: one exact basis solve gives the value
                        try:
                            cv, _ = exact_basis_solve(sfs[k], sol.basis)
                            xc = [cv.get(jj, Fraction(0))
                                  for jj in range(sfs[k].n)]
                            val = Fraction(
                                sfs[k].recover_solution(xc)[frac_name])
                        except (ZeroDivisionError, np.linalg.LinAlgError):
                            val = None
                    if val is None:
                        val = Fraction(bf).limit_denominator(10**9)

            # branch: each child differs from THIS node in one bound row's
            # b; park this node's terminal frame in the pool and encode the
            # sparse rewrite for the dual-simplex warm start
            lb, ub = bounds[frac_name]
            lo = Fraction(math.floor(val))
            hi = lo + 1
            zf = float(z)
            f_dist = float(val - lo)
            le_row, ge_row = root_sf.int_bound_rows[frac_name]
            slot = None
            if state_ref[k] is not None and free_slots:
                slot = free_slots.pop()
            warm_children = 0
            for child_lb, child_ub in ((lb, lo), (hi, ub)):
                if child_lb > child_ub:
                    continue
                child = dict(bounds)
                child[frac_name] = (child_lb, child_ub)
                warm_ref = None
                if slot is not None:
                    if child_ub != ub:       # down child: le row moves
                        row, delta_b = le_row, child_ub - ub
                    else:                    # up child: ge row moves
                        row, delta_b = ge_row, child_lb - lb
                    adj = row_adj.get(row)
                    # the delta rides in the int32 upload pack
                    if (adj is not None and delta_b.denominator == 1
                            and abs(delta_b) < 2 ** 31):
                        col, sign = adj
                        warm_ref = (slot, col, int(sign * delta_b))
                        warm_children += 1
                child_pc = None
                if pc is not None:
                    child_pc = ((frac_name, "down", f_dist)
                                if child_ub != ub
                                else (frac_name, "up", 1.0 - f_dist))
                heapq.heappush(
                    frontier,
                    (zf, next(counter),
                     z if exact_mode else Fraction(zf).limit_denominator(10**12),
                     child, warm_ref, child_pc, None))
            if slot is not None:
                if warm_children:
                    slot_refs[slot] = warm_children
                    pending_writes.append((state_ref[k], slot))
                else:
                    free_slots.append(slot)

        if outs:
            last_out = outs[-1][1]
        if pending_writes:
            # park every branched node's terminal frame in the pool. The
            # writes of ONE source state (the warm out when present) are
            # DEFERRED into the next warm wave; any other group (mixed
            # cold+warm waves, or an older unconsumed deferral) is written
            # now
            if deferred is not None:
                _flush(*deferred)
                deferred = None
            # grouped by the source tensor's identity: every group keeps
            # its source state alive, so no two live tensors share an id
            wgroups: Dict[int, Tuple[SimplexState, List[int], List[int]]] = {}
            for (out, lane), slot in pending_writes:
                g = wgroups.setdefault(id(out.T), (out, [], []))
                g[1].append(slot)
                g[2].append(lane)
            defer_key = None
            for idxs, out, is_warm, _ in outs:
                if id(out.T) in wgroups:
                    defer_key = id(out.T)  # later entry = warm out preferred
            for key, (out, slots, lanes) in wgroups.items():
                if key == defer_key:
                    deferred = (out, slots, lanes)
                else:
                    _flush(out, slots, lanes)

        if pc is not None:
            stats.pseudocost_updates = pc.updates
        if POOL_DEBUG:
            _pool_check()
        if checkpoint_path is not None and \
                stats.waves % max(checkpoint_every, 1) == 0:
            _checkpoint()
        stats.t_process += time.perf_counter() - _tp0

    if root_unbounded:
        sol = Solution(status="unbounded")
    elif incumbent is not None:
        # a nonempty frontier means an early stop: report the PROVEN gap
        # against the best open node bound (min sense)
        if frontier:
            best_open = min(zf for zf, *_ in frontier)
            inc_f = float(incumbent_z)
            gap = max(0.0, (inc_f - best_open) / max(abs(inc_f), 1.0))
            sol = dataclasses.replace(incumbent,
                                      status=stop_reason or "node_limit",
                                      mip_gap=gap)
        else:
            sol = dataclasses.replace(incumbent, status="optimal",
                                      mip_gap=0.0)
    elif stop_reason is not None:
        sol = Solution(status=stop_reason)
    elif stats.nodes_solved >= max_nodes:
        sol = Solution(status="node_limit")
    else:
        sol = Solution(status="infeasible")
    return (sol, stats) if return_stats else sol

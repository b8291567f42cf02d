"""``blocked_steps``: the solo rank-K blocked engine on the card, six
launches a pivot slot (``csrc/blocked.cu``) and B1's flush a block, and the
plain versions of the launches, stage by stage.

``solve.blocked._blocked_pivot`` is one eta pivot of ~200 small tensor ops
and three FMA launches. Its work has five global dependencies: the
clean-up row's first eligible column, pricing, the entering column
``T0[:, j] + V[:, j]^T U``, the leaving row and the pivot row ``T0[r] +
U[:, r]^T V``. Cut there, a slot is six stream-ordered launches that read
and write one walk record kept on the card:

- **cleanup** (a grid over the columns; returns at once unless a basic
  artificial remains in phase 2): the clean-up row and, per block, its
  first eligible column;
- **price** (one block): the eligible column from those partials, the
  retire, pricing on the maintained objective rows (Dantzig, Bland's first
  improving column, devex ``c^2 / gamma``), the phase bookkeeping, the
  finiteness of the pre-step pricing row and the entering column;
- **column** (a grid over the rows): the entering column;
- **ratio** (one block): ``driver.ratio_rows`` over the column and the RHS
  vector, with first-index or largest-pivot ties (Bland's smallest basic
  index under Bland), the slot's ``act`` (with the budget), the row and
  the pivot element;
- **row** (a grid over max(M, N)): the pivot row, the running vectors
  ``row0``, ``row1``, ``bvec`` (one fma an entry), the devex weights, and
  per block the weights' maximum and the post-step ``|bvec[2:]|`` sum;
- **finish** (one block): the eta slot ``U[t] = w``, ``V[t] = vrow``, the
  basis, the retire, the devex resets, the stall counter and the Bland
  switch, the phase change, the status, ``t`` and ``niter``, and the first
  row whose basic column is artificial (the next slot's clean-up scan).

After K slots B1 (``block.fused_flush``) flushes ``T += U^T V`` in place
and returns its scan columns, and one more launch, **ray**, evaluates the
per-block ray scan on them with the basic-artificial gate of the eager
engine and resets the carry for the next block (``row0``, ``row1``,
``bvec`` from the flushed T, the etas zero, ``t = 0``).

The record (``BlockedRecord``) holds the walk's state (copies of the
caller's tensors, which are never written), the block's eta factors and
running vectors, the slot's verdict (``ints`` past the scalars, ``vals``)
and the scratch one launch passes to the next. A batched record
(``make_batch_record``) holds the same fields with a leading lane axis,
contiguous, for ``blocked_cluster_batch``: there ``LIVE`` is each lane's
verdict at the block's start (running within its budget), which its
cluster launch writes and B1 and the ray launch obey; a solo record is
always live. Every slot launch returns at
once unless the record's status is RUNNING: the eager pivot's own gate. The
budget enters as it does there, through ``act``, so a slot past the budget
pivots nowhere and still records what ``_blocked_pivot`` records (an exit,
a phase change, a retire).

The eta sums run over the block's slots in one fixed order, k = 0 .. t,
one fma each (``_eta``; the slots past t are zero), accumulated in the
tableau's type, where the eager pivot's matrix products sum in the
library's order: the kernels and the plain stages agree bit for bit, and
both agree with the eager engine to rounding. The plain stages
(``blocked_{cleanup,price,column,ratio,row,finish,ray}_reference``) are the
launches' plain versions on the same record; ``blocked_pivot_reference``
composes one slot and ``blocked_block_reference`` a block with a given
flush. Nothing on the solver's path calls them: ``solve.blocked.
run_simplex_blocked`` runs the eager engine on CPU tensors and
``blocked_steps`` on CUDA tensors.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..core.state import (RULE_BLAND, RULE_DEVEX, TIE_MAXPIV, SimplexState,
                          SolverOptions, Status)
from .block import fused_flush, fused_flush_batch, fused_flush_reference
# the devex frame is re-anchored past this weight, as in the bounded walk
from .bounded import BIG_I, DEVEX_RESET_ABOVE as RESET_ABOVE
from .fma import fused_fma
from .launch import LAUNCHES, lib_for, raise_on, stream_of, suffix
from .sums import block_sums

__all__ = ["BlockedRecord", "make_record", "record_state", "record_tensors",
           "clone_record", "make_batch_record", "lane_record",
           "blocked_steps", "enqueue_slots", "blocked_block",
           "flush_and_ray", "flush_and_ray_batch", "ray_batch",
           "blocked_stage", "blocked_cleanup_reference",
           "blocked_price_reference", "blocked_column_reference",
           "blocked_ratio_reference", "blocked_row_reference",
           "blocked_finish_reference", "blocked_ray_reference",
           "blocked_stage_reference", "blocked_pivot_reference",
           "blocked_block_reference", "blocked_walk_reference",
           "flush_inputs", "partials", "STAGES", "SLOT_STAGES", "MAX_K",
           "RESET_ABOVE"]

MAX_K = 1024  # eta slots of a block (csrc/blocked.cu)
GRID_THREADS = 256  # threads of the grid launches (csrc/blocked.cu)

# the record's int32 fields: the walk's scalars, the slot t and the first
# row whose basic column is artificial; the slot's verdict (price writes
# CLEANUP..RETIRE, ratio the rest); the lane's verdict at the block's start
# (LIVE); then one partial a cleanup block
PHASE, STATUS, NITER, STUCK, BLAND, SLOT, ART_ROW = range(7)
(CLEANUP, R_D, HAS_ELIG, J, HAS_IMPROVING, INFEASIBLE, TO_PHASE2,
 PRICING_PIVOT, CROW_OK, RETIRE, DO_CLEANUP, DO_PRICING, ACT, R, LEAVING,
 UNBOUNDED, FAILED1, RAY, LIVE) = range(7, 26)
NI = 26
# the record's values in the tableau's type
LAST_Z, PIV, GAMMA_Q = range(3)
NV = 3
# the launches of a slot, then the block's ray launch
SLOT_STAGES = ("cleanup", "price", "column", "ratio", "row", "finish")
STAGES = SLOT_STAGES + ("ray",)

# the C entry points' argument arrays (csrc/blocked.cu)
_NARGS, _NINTS, _NTOLS = 14, 8, 5
_I_STAGE = 7
_ARGS = ctypes.c_longlong * _NARGS
_INTS = ctypes.c_int * _NINTS
_TOLS = ctypes.c_double * _NTOLS
_INT_MAX = 2 ** 31 - 1
# lanes of a batched launch (a grid's y and z extent)
_MAX_LANES = 65_535
# basis values go through the tableau's type in Bland's row tie: exact in
# float32 below 2^24
_MAX_SIDE = 1 << 24


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def partials(M: int, N: int) -> int:
    """Blocks of the row launch, each writing one partial (the scratch's
    size and the kernels' ``G``)."""
    return _cdiv(max(M, N), GRID_THREADS)


class BlockedRecord(NamedTuple):
    """One walk's state and its current block on one device, updated in
    place by the stages (a batched record: every field with a leading lane
    axis)."""

    T: torch.Tensor           # (M, N) T0, the block-start tableau
    U: torch.Tensor           # (K, M) eta vectors (zero beyond t)
    V: torch.Tensor           # (K, N) pivot rows (zero beyond t)
    row0: torch.Tensor        # (N,) the current phase-2 objective row
    row1: torch.Tensor        # (N,) the current phase-1 objective row
    bvec: torch.Tensor        # (M,) the current RHS column
    gamma: torch.Tensor       # (n,) devex weights (ones unless RULE_DEVEX)
    basis: torch.Tensor       # (m,) int32
    col_active: torch.Tensor  # (n,) bool
    art_cols: torch.Tensor    # (n,) bool
    ca: torch.Tensor          # (N,) int32: col_active for B1, 0 at the RHS
    ints: torch.Tensor        # (NI + cleanup blocks,) int32
    vals: torch.Tensor        # (NV,) last_z and the slot's values
    scratch: torch.Tensor     # (M + N + 2 G,) colj | vrow | row partials


def make_record(state: SimplexState, K: int) -> BlockedRecord:
    """A record of ``state`` for blocks of ``K`` pivots: copies of its
    tensors and the first block's carry (``solve.blocked._fresh_carry``:
    the etas zero, the devex weights ones)."""
    return _make(state, K, ())


def make_batch_record(batched: SimplexState, K: int) -> BlockedRecord:
    """``make_record`` of every lane of a batched state, as one record
    with a leading lane axis, each field contiguous."""
    return _make(batched, K, tuple(batched.T.shape[:1]))


def _make(state: SimplexState, K: int, lanes: tuple) -> BlockedRecord:
    T = state.T
    M, N = T.shape[-2:]
    n = N - 1
    dev, dt = T.device, T.dtype
    i32 = dict(dtype=torch.int32, device=dev)
    T = T.clone(memory_format=torch.contiguous_format)
    art_basic = torch.gather(state.art_cols, -1, state.basis.long())
    ints = torch.zeros(lanes + (NI + _cdiv(n, GRID_THREADS),), **i32)
    first_art = torch.where(art_basic.any(-1),
                            torch.argmax(art_basic.to(torch.int32), -1),
                            BIG_I)
    ints[..., :ART_ROW + 1] = torch.stack([x.to(torch.int32) for x in (
        state.phase, state.status, state.niter, state.stuck, state.bland,
        torch.zeros(lanes, **i32), first_art)], -1)
    ints[..., LIVE] = 1
    vals = torch.zeros(lanes + (NV,), dtype=dt, device=dev)
    vals[..., LAST_Z] = state.last_z
    kw = dict(dtype=dt, device=dev)
    return BlockedRecord(
        T=T, U=torch.zeros(lanes + (K, M), **kw),
        V=torch.zeros(lanes + (K, N), **kw), row0=_copy(T[..., 0, :]),
        row1=_copy(T[..., 1, :]), bvec=_copy(T[..., :, -1]),
        gamma=torch.ones(lanes + (n,), **kw),
        basis=state.basis.to(torch.int32).clone(),
        col_active=state.col_active.clone(),
        art_cols=state.art_cols.clone(),
        ca=torch.zeros(lanes + (N,), **i32), ints=ints, vals=vals,
        scratch=torch.zeros(lanes + (M + N + 2 * partials(M, N),), **kw))


def _copy(x: torch.Tensor) -> torch.Tensor:
    return x.clone(memory_format=torch.contiguous_format)


def lane_record(rec: BlockedRecord, k: int) -> BlockedRecord:
    """Lane ``k`` of a batched record: views, which the plain stages
    update in place."""
    return BlockedRecord(*(x[k] for x in rec))


def record_tensors(rec: BlockedRecord):
    """(name, tensor) of the record's tensors."""
    return list(zip(rec._fields, rec))


def clone_record(rec: BlockedRecord) -> BlockedRecord:
    return BlockedRecord(*(x.clone() for x in rec))


def record_state(rec: BlockedRecord) -> SimplexState:
    """The walk's state with the record's fields (T is the block-start
    tableau: the walk's own after the flush that ends its block); of a
    batched record, the batched state."""
    ints = rec.ints
    return SimplexState(
        T=rec.T, basis=rec.basis, col_active=rec.col_active,
        art_cols=rec.art_cols, phase=ints[..., PHASE],
        status=ints[..., STATUS], niter=ints[..., NITER],
        stuck=ints[..., STUCK], bland=ints[..., BLAND] != 0,
        last_z=rec.vals[..., LAST_Z])


# ---------------------------------------------------------------------------
# the plain stages
# ---------------------------------------------------------------------------

def _running(iv) -> bool:
    return iv[STATUS] == Status.RUNNING


def _slot(iv, rec: BlockedRecord) -> int:
    return min(iv[SLOT], rec.U.shape[0] - 1)


def _eta(coef: torch.Tensor, X: torch.Tensor, t: int) -> torch.Tensor:
    """``sum_{k <= t} coef[k] X[k]``: one fma a slot, in slot order (the
    kernels' ``eta_dot``)."""
    acc = torch.zeros(X.shape[1:], dtype=X.dtype, device=X.device)
    for k in range(t + 1):
        acc = fused_fma(acc, coef[k], X[k])
    return acc


def _block_sum(x: torch.Tensor) -> torch.Tensor:
    """The sums of ``x`` (G, GRID_THREADS), a value a thread, as the grid
    launches' block reduction adds them (``sums.block_sums``)."""
    return block_sums(x.reshape(-1), GRID_THREADS, x.shape[0], GRID_THREADS)


def _w(rec: BlockedRecord, iv) -> torch.Tensor:
    """The slot's eta vector ``(e_{r+2} - colj) / safe_piv * actf``."""
    M = rec.T.shape[0]
    act = bool(iv[ACT])
    spiv = rec.vals[PIV] if act else torch.ones((), dtype=rec.T.dtype,
                                                device=rec.T.device)
    onehot = (torch.arange(M, device=rec.T.device) == iv[R] + 2).to(
        rec.T.dtype)
    return (onehot - rec.scratch[:M]) / spiv * (1.0 if act else 0.0)


def blocked_cleanup_reference(rec: BlockedRecord, opts: SolverOptions,
                              max_iters: int) -> None:
    """The cleanup launch's plain version: the clean-up row's first
    eligible column per block of ``GRID_THREADS`` columns, into the
    record's partials."""
    iv = rec.ints.tolist()
    if not _running(iv) or iv[ART_ROW] == BIG_I or iv[PHASE] != 2:
        return
    T = rec.T
    n = T.shape[1] - 1
    rg = iv[ART_ROW] + 2
    rowd = T[rg] + _eta(rec.U[:, rg], rec.V, _slot(iv, rec))
    elig = (rec.col_active & ~rec.art_cols
            & (rowd[:-1].abs() > opts.piv_tol))
    blocks = _cdiv(n, GRID_THREADS)
    first = torch.full((blocks * GRID_THREADS,), BIG_I, dtype=torch.int32,
                       device=T.device)
    first[:n] = torch.where(elig, torch.arange(n, device=T.device),
                            BIG_I).to(torch.int32)
    rec.ints[NI:NI + blocks] = first.view(blocks, GRID_THREADS).amin(dim=1)


def blocked_price_reference(rec: BlockedRecord, opts: SolverOptions,
                            max_iters: int) -> None:
    """The price launch's plain version: the retire, pricing, the phase
    bookkeeping, the finiteness of the pre-step pricing row and the
    entering column, into the record's verdict."""
    iv = rec.ints.tolist()
    if not _running(iv):
        return
    inf = float("inf")
    N = rec.T.shape[1]
    n = N - 1
    phase, ar = iv[PHASE], iv[ART_ROW]
    cleanup = ar != BIG_I and phase == 2
    crow = (rec.row1 if phase == 1 else rec.row0)[:-1]
    c_eff = torch.where(rec.col_active, crow, inf)
    improving = c_eff < -opts.opt_tol
    has_improving = bool(improving.any())
    if opts.rule == RULE_DEVEX:
        j_best = int(torch.argmax(torch.where(
            improving, (crow * crow) / rec.gamma, -inf)))
    else:
        j_best = int(torch.argmin(c_eff))
    if bool(iv[BLAND]) or opts.rule == RULE_BLAND:
        j_price = int(torch.argmax(improving.to(torch.int32))) \
            if has_improving else n - 1
    else:
        j_price = j_best
    jd = min(iv[NI:NI + _cdiv(n, GRID_THREADS)]) if cleanup else BIG_I
    has_elig = jd != BIG_I
    phase1_done = phase == 1 and not has_improving
    infeasible = phase1_done and bool(-rec.row1[-1] > opts.infeas_tol)
    crow_ok = bool(torch.isfinite(
        torch.where(rec.col_active, crow.abs(), 0.0).sum()))
    j = (jd if has_elig else n - 1) if cleanup else j_price
    verdict = {CLEANUP: cleanup, R_D: ar if ar != BIG_I else 0,
               HAS_ELIG: has_elig, J: j, HAS_IMPROVING: has_improving,
               INFEASIBLE: infeasible,
               TO_PHASE2: phase1_done and not infeasible,
               PRICING_PIVOT: has_improving and not cleanup and phase != 0,
               CROW_OK: crow_ok, RETIRE: cleanup and not has_elig}
    for k, v in verdict.items():
        rec.ints[k] = int(v)
    rec.vals[GAMMA_Q] = rec.gamma[j]


def blocked_column_reference(rec: BlockedRecord, opts: SolverOptions,
                             max_iters: int) -> None:
    """The column launch's plain version: ``colj = T0[:, j] + sum_k V[k, j]
    U[k]`` into the scratch."""
    iv = rec.ints.tolist()
    if not _running(iv):
        return
    j = iv[J]
    M = rec.T.shape[0]
    rec.scratch[:M] = rec.T[:, j] + _eta(rec.V[:, j], rec.U, _slot(iv, rec))


def blocked_ratio_reference(rec: BlockedRecord, opts: SolverOptions,
                            max_iters: int) -> None:
    """The ratio launch's plain version: ``driver.ratio_rows`` over the
    entering column and ``bvec``, the slot's ``act``, row and pivot."""
    iv = rec.ints.tolist()
    if not _running(iv):
        return
    inf = float("inf")
    M = rec.T.shape[0]
    col, b = rec.scratch[2:M], rec.bvec[2:]
    pos = col > opts.piv_tol
    has_ratio = bool(pos.any())
    ratios = torch.where(pos, b / torch.where(pos, col, 1.0), inf)
    tie = ratios <= ratios.min()
    if bool(iv[BLAND]) or opts.rule == RULE_BLAND:
        r_price = int(torch.argmin(torch.where(tie, rec.basis, BIG_I)))
    elif opts.tie_break == TIE_MAXPIV:
        r_price = int(torch.argmax(torch.where(tie, col, -inf)))
    else:
        r_price = int(torch.argmax(tie.to(torch.int32)))
    pricing_pivot = bool(iv[PRICING_PIVOT])
    in_phase2 = iv[PHASE] == 2
    do_cleanup = bool(iv[CLEANUP]) and bool(iv[HAS_ELIG])
    do_pricing = pricing_pivot and has_ratio
    r = iv[R_D] if do_cleanup else r_price
    verdict = {DO_CLEANUP: do_cleanup, DO_PRICING: do_pricing,
               ACT: (do_cleanup or do_pricing) and iv[NITER] < max_iters,
               R: r, LEAVING: int(rec.basis[r]),
               UNBOUNDED: pricing_pivot and not has_ratio and in_phase2,
               FAILED1: pricing_pivot and not has_ratio and not in_phase2}
    for k, v in verdict.items():
        rec.ints[k] = int(v)
    rec.vals[PIV] = rec.scratch[r + 2]


def blocked_row_reference(rec: BlockedRecord, opts: SolverOptions,
                          max_iters: int) -> None:
    """The row launch's plain version: the pivot row ``vrow`` into the
    scratch, ``row0``, ``row1`` and ``bvec`` by one fma an entry, the devex
    weights, and the row launch's per-block partials."""
    iv = rec.ints.tolist()
    if not _running(iv):
        return
    T = rec.T
    M, N = T.shape
    n = N - 1
    G = partials(M, N)
    act = bool(iv[ACT])
    rg = iv[R] + 2
    vrow = (T[rg] + _eta(rec.U[:, rg], rec.V, _slot(iv, rec))) \
        * (1.0 if act else 0.0)
    w = _w(rec, iv)
    rec.scratch[M:M + N] = vrow
    rec.row0.copy_(fused_fma(rec.row0, w[0], vrow))
    rec.row1.copy_(fused_fma(rec.row1, w[1], vrow))
    rec.bvec.copy_(fused_fma(rec.bvec, w, vrow[-1]))
    gmax = torch.full((G * GRID_THREADS,), -float("inf"), dtype=T.dtype,
                      device=T.device)
    if opts.rule == RULE_DEVEX:
        if act and iv[DO_PRICING]:
            spiv, gq = rec.vals[PIV], rec.vals[GAMMA_Q]
            alpha = vrow[:-1] / spiv
            gamma = torch.maximum(rec.gamma, (alpha * alpha) * gq)
            gamma[iv[LEAVING]] = torch.clamp_min(gq / (spiv * spiv), 1.0)
            rec.gamma.copy_(gamma)
        gmax[:n] = rec.gamma
    babs = torch.zeros((G * GRID_THREADS,), dtype=T.dtype, device=T.device)
    babs[2:M] = rec.bvec[2:].abs()
    rec.scratch[M + N:M + N + G] = gmax.view(G, GRID_THREADS).amax(dim=1)
    rec.scratch[M + N + G:] = _block_sum(babs.view(G, GRID_THREADS))


def blocked_finish_reference(rec: BlockedRecord, opts: SolverOptions,
                             stall_limit: int, max_iters: int) -> None:
    """The finish launch's plain version: the eta slot, the basis, the
    retire, the devex resets, the stall counter and the Bland switch, the
    phase change, the finiteness sums, the status, ``t``, ``niter`` and the
    first row whose basic column is artificial."""
    iv = rec.ints.tolist()
    if not _running(iv):
        return
    inf = float("inf")
    T = rec.T
    M, N = T.shape
    G = partials(M, N)
    slot, phase = iv[SLOT], iv[PHASE]
    act, to_phase2 = bool(iv[ACT]), bool(iv[TO_PHASE2])
    if slot < rec.U.shape[0]:
        rec.U[slot] = _w(rec, iv)
        rec.V[slot] = rec.scratch[M:M + N]
    gmax = torch.full((), -inf, dtype=T.dtype, device=T.device)
    bsum = torch.zeros((), dtype=T.dtype, device=T.device)
    for b in range(G):
        gmax = torch.maximum(gmax, rec.scratch[M + N + b])
        bsum = bsum + rec.scratch[M + N + G + b]
    if act:
        rec.basis[iv[R]] = iv[J]
    if iv[RETIRE]:
        rec.art_cols[int(rec.basis[iv[R_D]])] = False
    if opts.rule == RULE_DEVEX and (bool(gmax > RESET_ABOVE) or to_phase2):
        rec.gamma.fill_(1.0)
    if to_phase2:
        rec.col_active.copy_(rec.col_active & ~rec.art_cols)
    art_basic = rec.art_cols[rec.basis.long()]
    ar = int(torch.argmax(art_basic.to(torch.int32))) \
        if bool(art_basic.any()) else BIG_I

    z = -(rec.row1[-1] if phase == 1 else rec.row0[-1])
    last_z = rec.vals[LAST_Z].clone()
    stuck = iv[STUCK]
    if iv[DO_PRICING] and act:
        stuck = 0 if bool((last_z - z) > opts.degen_tol) else stuck + 1
        last_z = z
    bland = bool(iv[BLAND]) or stuck >= stall_limit
    new_phase = phase
    if to_phase2:
        new_phase, stuck = 2, 0
        last_z = torch.full_like(last_z, inf)
    finite_ok = (bool(torch.isfinite(z)) and bool(torch.isfinite(bsum))
                 and bool(iv[CROW_OK]))
    finished_opt = (phase == 2 and not iv[HAS_IMPROVING]
                    and not iv[CLEANUP])
    if not finite_ok:
        status = Status.NUMERIC
    elif iv[INFEASIBLE] or iv[FAILED1]:
        status = Status.INFEASIBLE
    elif iv[UNBOUNDED]:
        status = Status.UNBOUNDED
    elif finished_opt:
        status = Status.OPTIMAL
    else:
        status = Status.RUNNING
    rec.vals[LAST_Z] = last_z
    for k, v in ((PHASE, new_phase), (STUCK, stuck), (BLAND, bland),
                 (NITER, iv[NITER] + act), (SLOT, slot + act),
                 (ART_ROW, ar), (STATUS, status)):
        rec.ints[k] = int(v)


def blocked_ray_reference(rec: BlockedRecord, scan: torch.Tensor,
                          opts: SolverOptions) -> None:
    """The ray launch's plain version: the per-block ray scan on B1's scan
    columns ``scan`` (an improving active column with no entry above
    ``piv_tol``, no artificial basic, phase 2, running), then the next
    block's carry: ``row0``, ``row1``, ``bvec`` from the flushed T, the
    etas zero, ``t = 0``."""
    iv = rec.ints.tolist()
    if not iv[LIVE]:
        return
    ray = (bool(((scan[0] > 0) & ~(scan[1] > 0)).any())
           and iv[ART_ROW] == BIG_I and iv[PHASE] == 2 and _running(iv))
    rec.ints[RAY] = int(ray)
    if ray:
        rec.ints[STATUS] = Status.UNBOUNDED
    rec.ints[SLOT] = 0
    rec.U.zero_()
    rec.V.zero_()
    rec.row0.copy_(rec.T[0])
    rec.row1.copy_(rec.T[1])
    rec.bvec.copy_(rec.T[:, -1])


def blocked_stage_reference(rec: BlockedRecord, stage: str,
                            opts: SolverOptions, stall_limit: int,
                            max_iters: int,
                            scan: torch.Tensor | None = None) -> None:
    """The plain version of one launch, ``stage`` one of ``STAGES`` (the
    ray launch with B1's ``scan``)."""
    if stage == "finish":
        blocked_finish_reference(rec, opts, stall_limit, max_iters)
    elif stage == "ray":
        blocked_ray_reference(rec, scan, opts)
    else:
        {"cleanup": blocked_cleanup_reference,
         "price": blocked_price_reference,
         "column": blocked_column_reference,
         "ratio": blocked_ratio_reference,
         "row": blocked_row_reference}[stage](rec, opts, max_iters)


def blocked_pivot_reference(rec: BlockedRecord, opts: SolverOptions,
                            stall_limit: int, max_iters: int) -> None:
    """One pivot slot as the plain stages, in the launches' order."""
    for stage in SLOT_STAGES:
        blocked_stage_reference(rec, stage, opts, stall_limit, max_iters)


def flush_inputs(rec: BlockedRecord):
    """B1's operands ``(T, U, V, ca)`` of the record's block, ``ca`` set
    from the record's ``col_active`` (0 at the RHS)."""
    rec.ca[..., :-1].copy_(rec.col_active)
    return rec.T, rec.U, rec.V, rec.ca


def blocked_block_reference(rec: BlockedRecord, opts: SolverOptions,
                            stall_limit: int, max_iters: int,
                            flush=fused_flush_reference) -> None:
    """One block as the plain stages: K slots, the rank-K flush through
    ``flush`` (``block.fused_flush`` or its plain version), then the ray
    stage on its scan columns."""
    for _ in range(rec.U.shape[0]):
        blocked_pivot_reference(rec, opts, stall_limit, max_iters)
    _, scan = flush(*flush_inputs(rec), float(opts.opt_tol),
                    float(opts.piv_tol))
    blocked_ray_reference(rec, scan, opts)


def _walk(rec: BlockedRecord, max_iters: int, block) -> None:
    """``block(rec)`` until the walk ends or reaches ``max_iters``: one host
    read of (status, niter) a block, as the eager engine."""
    while True:
        status, niter = rec.ints[STATUS:NITER + 1].tolist()
        if status != Status.RUNNING or niter >= max_iters:
            return
        block(rec)


def _walk_batch(rec: BlockedRecord, max_iters: int, block) -> None:
    """``block(rec)`` on a batched record while any lane is running within
    ``max_iters``: one host read of every lane's (status, niter) a block,
    as the eager batch."""
    while any(status == Status.RUNNING and niter < max_iters
              for status, niter in rec.ints[:, STATUS:NITER + 1].tolist()):
        block(rec)


def blocked_walk_reference(state: SimplexState, opts: SolverOptions,
                           stall_limit: int, max_iters: int, K: int,
                           flush=fused_flush_reference):
    """The walk of ``state`` as the plain stages in blocks of ``K``, each
    flushed through ``flush``. Returns (state, devex weights); a RUNNING
    exit at the budget stays RUNNING. The caller's tensors are never
    written."""
    rec = make_record(state, K)
    _walk(rec, max_iters, lambda r: blocked_block_reference(
        r, opts, stall_limit, max_iters, flush))
    return record_state(rec), rec.gamma


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _check(state: SimplexState, K: int, batched: bool = False) -> None:
    """Raise on a state the kernels do not take: a dtype other than f32 /
    f64, a strided tableau, a field of the wrong type or length, a tensor
    off the card or on another card, a block past ``MAX_K``; ``batched``:
    the same with a leading lane axis on every field."""
    T = state.T
    suffix(T.dtype)
    lanes = tuple(T.shape[:1]) if batched else ()
    if T.dim() != 2 + len(lanes) or not T.is_contiguous():
        shape = "(B, m + 2, n + 1)" if batched else "(m + 2, n + 1)"
        raise ValueError(f"T: expected a contiguous {shape} tableau, got "
                         f"{tuple(T.shape)} stride {T.stride()}")
    if batched and not 1 <= T.shape[0] <= _MAX_LANES:
        raise ValueError(f"{T.shape[0]} lanes outside 1..{_MAX_LANES}")
    M, N = T.shape[-2:]
    if M < 3 or N < 2 or max(M, N) >= _MAX_SIDE:
        raise ValueError(f"tableau {M} x {N} outside 3..2^24 x 2..2^24")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"block of {K} pivots outside 1..{MAX_K}")
    m, n = M - 2, N - 1
    for name, x, dt, shape in (
            ("basis", state.basis, torch.int32, (m,)),
            ("col_active", state.col_active, torch.bool, (n,)),
            ("art_cols", state.art_cols, torch.bool, (n,)),
            ("phase", state.phase, torch.int32, ()),
            ("status", state.status, torch.int32, ()),
            ("niter", state.niter, torch.int32, ()),
            ("stuck", state.stuck, torch.int32, ()),
            ("bland", state.bland, torch.bool, ()),
            ("last_z", state.last_z, T.dtype, ())):
        shape = lanes + shape
        if x.dtype != dt or tuple(x.shape) != shape:
            raise ValueError(f"{name}: expected {dt} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
    if T.device.type != "cuda" or any(x.device != T.device for x in state):
        raise ValueError("the blocked kernels take a state on one CUDA "
                         "device; got "
                         f"{sorted({str(x.device) for x in state})}")


def _entry(rec: BlockedRecord, opts: SolverOptions, stall_limit: int,
           max_iters: int, scan: torch.Tensor | None = None):
    """(library, the entry's argument arrays) for a record of
    ``make_record`` (or ``make_batch_record``) on one CUDA device."""
    T = rec.T
    M, N = T.shape[-2:]
    K = rec.U.shape[-2]
    lanes = tuple(T.shape[:-2])
    tensors = list(rec) + ([] if scan is None else [scan])
    if T.device.type != "cuda" or any(x.device != T.device or
                                      not x.is_contiguous()
                                      for x in tensors):
        raise ValueError("the blocked kernels take a record of contiguous "
                         "tensors on one CUDA device")
    if (len(lanes) > 1 or tuple(rec.ints.shape) != lanes + (
            NI + _cdiv(N - 1, GRID_THREADS),)
            or tuple(rec.scratch.shape) != lanes + (
                M + N + 2 * partials(M, N),)
            or tuple(rec.U.shape) != lanes + (K, M)
            or tuple(rec.V.shape) != lanes + (K, N)
            or tuple(rec.vals.shape) != lanes + (NV,)
            or any(tuple(x.shape[:len(lanes)]) != lanes for x in rec)
            or not 1 <= K <= MAX_K):
        raise ValueError("not a record of make_record or make_batch_record")
    args = _ARGS(*(0 if x is None else x.data_ptr() for x in (
        T, rec.U, rec.V, rec.row0, rec.row1, rec.bvec, rec.gamma, rec.basis,
        rec.col_active, rec.art_cols, rec.ints, rec.vals, rec.scratch,
        scan)))
    iargs = _INTS(M, N, K, min(int(stall_limit), _INT_MAX),
                  min(int(max_iters), _INT_MAX), int(opts.rule),
                  int(opts.tie_break), 0)
    tols = _TOLS(opts.opt_tol, opts.piv_tol, opts.degen_tol,
                 opts.infeas_tol, RESET_ABOVE)
    return lib_for(T.device), args, iargs, tols


def enqueue_slots(rec: BlockedRecord, opts: SolverOptions, stall_limit: int,
                  max_iters: int, nslots: int) -> None:
    """Enqueue ``nslots`` pivot slots (six launches each; at most the
    block's K) on a record on the card through one C call, with no host
    read; counted in ``LAUNCHES["blocked_step"]``."""
    lib, args, iargs, tols = _entry(rec, opts, stall_limit, max_iters)
    fn = getattr(lib, f"tpulp_blocked_steps_{suffix(rec.T.dtype)}")
    err = fn(args, iargs, tols, int(nslots), stream_of(rec.T.device))
    if err:
        raise_on(lib, err, "blocked step")
    LAUNCHES["blocked_step"] += nslots


def _launch(rec: BlockedRecord, stage: str, opts: SolverOptions,
            stall_limit: int, max_iters: int,
            scan: torch.Tensor | None = None) -> None:
    lib, args, iargs, tols = _entry(rec, opts, stall_limit, max_iters, scan)
    iargs[_I_STAGE] = STAGES.index(stage)
    fn = getattr(lib, f"tpulp_blocked_stage_{suffix(rec.T.dtype)}")
    err = fn(args, iargs, tols, stream_of(rec.T.device))
    if err:
        raise_on(lib, err, f"blocked {stage}")


def ray_batch(rec: BlockedRecord, scan: torch.Tensor, opts: SolverOptions,
              stall_limit: int, max_iters: int) -> None:
    """The ray launch of every lane of a batched record on the card, each
    lane on its B1 scan columns ``scan[lane]`` (B, 2, N); a lane that is not
    ``LIVE`` is left as it is (counted in ``LAUNCHES["blocked_ray_batch"]``,
    one a launch)."""
    B, N = rec.T.shape[0], rec.T.shape[-1]
    if rec.T.dim() != 3 or tuple(scan.shape) != (B, 2, N) \
            or scan.dtype != torch.int32:
        raise ValueError(f"ray_batch: expected a batched record and (B, 2, "
                         f"N) int32 scan columns, got {tuple(rec.T.shape)} "
                         f"and {scan.dtype} {tuple(scan.shape)}")
    lib, args, iargs, tols = _entry(rec, opts, stall_limit, max_iters, scan)
    fn = getattr(lib, f"tpulp_blocked_ray_batch_{suffix(rec.T.dtype)}")
    err = fn(args, iargs, tols, B, stream_of(rec.T.device))
    if err:
        raise_on(lib, err, "blocked ray batch")
    LAUNCHES["blocked_ray_batch"] += 1


def flush_and_ray(rec: BlockedRecord, opts: SolverOptions, stall_limit: int,
                  max_iters: int) -> None:
    """A block's end on the card: B1's flush, then the ray launch (counted
    in ``LAUNCHES["blocked_ray"]``)."""
    _, scan = fused_flush(*flush_inputs(rec), float(opts.opt_tol),
                          float(opts.piv_tol))
    _launch(rec, "ray", opts, stall_limit, max_iters, scan)
    LAUNCHES["blocked_ray"] += 1


def flush_and_ray_batch(rec: BlockedRecord, opts: SolverOptions,
                        stall_limit: int, max_iters: int) -> None:
    """A block's end on the card for every lane of a batched record: one B1
    launch (``block.fused_flush_batch``) and one ray launch over the lanes,
    both skipping a lane whose ``LIVE`` is 0."""
    _, scan = fused_flush_batch(*flush_inputs(rec), rec.ints[:, LIVE],
                                float(opts.opt_tol), float(opts.piv_tol))
    ray_batch(rec, scan, opts, stall_limit, max_iters)


def blocked_block(rec: BlockedRecord, opts: SolverOptions, stall_limit: int,
                  max_iters: int) -> None:
    """One block on the card: K slots, B1's flush, the ray launch."""
    enqueue_slots(rec, opts, stall_limit, max_iters, rec.U.shape[0])
    flush_and_ray(rec, opts, stall_limit, max_iters)


def blocked_steps(state: SimplexState, opts: SolverOptions, stall_limit: int,
                  max_iters: int, K: int):
    """The rank-K blocked walk of ``state`` (one problem on one CUDA
    device) in blocks of ``K`` pivots, ``solve.blocked``'s eager engine on
    the card, to its exit or to ``max_iters``: a block is its K slots
    enqueued by one C call, B1's flush and the ray launch, with one host
    read of (status, niter) a block; a RUNNING exit at the budget stays
    RUNNING. Returns (state, devex weights); the caller's tensors are never
    written."""
    _check(state, K)
    rec = make_record(state, K)
    _walk(rec, max_iters,
          lambda r: blocked_block(r, opts, stall_limit, max_iters))
    return record_state(rec), rec.gamma


def blocked_stage(rec: BlockedRecord, stage: str, opts: SolverOptions,
                  stall_limit: int, max_iters: int,
                  scan: torch.Tensor | None = None) -> None:
    """One launch of ``stage`` (one of ``STAGES``; the ray launch with B1's
    ``scan``) on a record on the card, in place: what holds each launch
    against its plain stage."""
    _launch(rec, stage, opts, stall_limit, max_iters, scan)
    LAUNCHES["blocked_stage"] += 1

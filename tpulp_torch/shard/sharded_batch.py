"""Lane-sharded batched simplex over a ``(batch, cols)`` DeviceMesh.

The counterpart of tpulp's path A over a batch (``run_simplex_batch_gspmd``
and the B&B waves that GSPMD compiles over a sharded template): the LP
domain's (dp, tp) layout. torch has no GSPMD, so the layout is explicit
and multi-controller, one process per device:

* the ``batch`` axis splits the lanes: each process runs its ``B / P_batch``
  lanes, with no collective between ``batch`` shards inside a solve and one
  ``all_gather`` (``LaneMesh.gather``, every field packed in one tensor) at
  its end;
* the ``cols`` axis splits each lane's tableau exactly as
  ``shard/sharded.py`` splits one LP: the (m+2, n) coefficient block in
  contiguous column blocks, the RHS column, the basis and the scalars
  replicated. A step is ``torch.func.vmap`` of path B's rank-1 step
  (``sharded._sharded_step``) or of the dual step below over the local
  lanes; under vmap each collective of ``comm.MeshAxis`` is ONE call that
  carries every local lane, so a lane-sharded primal step makes path B's
  four collectives (the (m,) artificial scan, the packed candidate
  ``all_gather``, the entering column's psum, the finiteness psum) and a
  dual step three, whatever the lanes per process; on the card its pivot
  is one ``shard_pivot`` launch over the local lanes, which writes each
  lane's block and RHS as a frame that the next step reads in place;
* a mesh without ``cols`` leaves columns whole (``WHOLE``, an axis of one
  shard that does not communicate): its frames are the solo layout, so
  its lanes run the solo lane loops (``solve.lanes``: on the card the
  lane kernels, one launch a loop), with no collective in the loop.

Pricing and ratio ties keep first-index semantics across shards, and the
entering column's psum adds exact zeros from the shards that do not own
it, so each lane walks the solo batched driver's walk: the same pivots,
and a tableau equal bit for bit up to the sign of zero entries (a psum
of -0.0 and +0.0 is +0.0, and the idle step's unit column is built with
+0.0), which no decision and no non-zero value reads. The chunked loop
(``driver.run_chunked``) stops on lane status and ``niter``, which are
replicated inside a ``cols`` group; ``batch`` groups may stop at
different chunks, since they share no collective in the loop.

The B&B waves work on *frames*: a lane's coefficient block with its RHS
column appended, ``(m+2, n_local + 1)``, so that a state pool of frames,
its writes and the wave summaries keep the solo layout
(``solve/dual.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..comm.collectives import MeshAxis
from ..core.state import SimplexState, SolverOptions, Status
from ..kernels.shard_pivot import shard_pivot
from ..solve.driver import BIG_I, finish, first_true, put, take
from ..solve.lanes import dual_lanes, primal_lanes, run_lanes
from .sharded import (ShardedState, _fetch_column, _gather_cols,
                      _local_block, _pad_cols, _sharded_step,
                      gather_candidates, local_ids, unit_row2)

__all__ = [
    "WHOLE",
    "LaneMesh",
    "split_frames",
    "join_frames",
    "run_simplex_batch_sharded",
    "run_dual_batch_sharded",
]


class _Whole:
    """The column axis of a mesh without one: a single shard, whose
    collectives return their input and are not counted."""

    index = 0
    size = 1

    def psum(self, x):
        return x

    def all_gather(self, x):
        return x.unsqueeze(0)


WHOLE = _Whole()


def split_frames(fr: SimplexState) -> ShardedState:
    """Frames (the block with its RHS column appended) as the drivers'
    ``ShardedState``: views, no copy."""
    return ShardedState(fr.T[..., :-1], fr.T[..., -1], *fr[1:])


def join_frames(sh: ShardedState) -> SimplexState:
    """A ``ShardedState`` as frames."""
    return SimplexState(torch.cat([sh.T, sh.rhs[..., None]], dim=-1),
                        *sh[2:])


def run_simplex_batch_sharded(sh: ShardedState, lay, opts: SolverOptions,
                              stall_limit: int,
                              max_iters: Optional[int] = None
                              ) -> ShardedState:
    """Path B's rank-1 step vmapped over the local lanes of ``sh`` (a
    ShardedState with a leading lane axis) until no lane runs below
    ``max_iters`` (default ``opts.max_iters``); ``lay`` is the column axis
    (a ``MeshAxis`` or ``WHOLE``). Every pricing rule and tie break of
    ``driver.simplex_step`` holds. Lanes still RUNNING are left so."""
    max_iters = opts.max_iters if max_iters is None else max_iters
    n_global = sh.T.shape[-1] * lay.size
    return run_lanes(
        lambda s: _sharded_step(s, opts, stall_limit, n_global, lay,
                                max_iters, every_rule=True), sh, max_iters)


def _sharded_dual_step(s: ShardedState, opts: SolverOptions,
                       stall_limit: int, lay, max_iters=None
                       ) -> ShardedState:
    """One dual-simplex transition (``solve.dual.dual_simplex_step``) over
    the column-sharded layout: the leaving row from the replicated RHS; the
    dual ratio test over each shard's columns, its (min ratio, first tying
    column, first eligible column) riding one packed ``all_gather``; the
    entering column by psum; the update local."""
    T = s.T
    inf = float("inf")
    n_local = T.shape[-1]
    running = s.status == Status.RUNNING
    if max_iters is not None:
        running = running & (s.niter < max_iters)

    b = s.rhs[2:]
    m = b.shape[0]
    neg = b < -opts.feas_tol
    feasible = ~neg.any()

    # ---- leaving row: most-negative b; first-negative after stall ----------
    r = torch.where(s.bland, first_true(neg, m - 1), torch.argmin(b))

    # ---- entering column: the dual ratio test over the shards --------------
    row = take(T, r + 2, 0)
    crow = T[0]
    elig = s.col_active & (row < -opts.piv_tol)
    ratios = torch.where(elig, crow / torch.where(elig, -row, 1.0), inf)
    l_min = ratios.min()
    tie = elig & (ratios <= l_min)
    ids = local_ids(n_local, lay, T.device)
    g_vals, g_idxs, first_elig, _ = gather_candidates(
        l_min, torch.argmax(tie.to(torch.int32)) + lay.index * n_local,
        torch.where(elig, ids, BIG_I).min(), torch.full_like(ids[0], BIG_I),
        lay)
    has_elig = first_elig < BIG_I
    # the first shard holding the global minimum holds its first column
    j = take(g_idxs, torch.argmin(g_vals))

    became_optimal = running & feasible
    do_pivot = running & ~feasible & has_elig
    became_infeasible = running & ~feasible & ~has_elig

    # ---- the one pivot (the exact no-op on (row 2, basis[0]) when idle) ---
    u = _fetch_column(T, j, lay)
    rg = torch.where(do_pivot, r + 2, 2)
    j_eff = torch.where(do_pivot, j.long(), s.basis[0].long())
    u_eff = torch.where(do_pivot, u, unit_row2(T.shape[0], T))
    Tn, rhsn = shard_pivot(T, s.rhs, u_eff, rg, j_eff, lay.index)
    basis = torch.where(do_pivot, put(s.basis, r, j), s.basis)

    # ---- stall detection: the dual objective does not decrease ------------
    z = -rhsn[0]
    improved = (z - s.last_z) > opts.degen_tol
    stuck = torch.where(do_pivot,
                        torch.where(improved, 0, s.stuck + 1),
                        s.stuck).to(torch.int32)
    last_z = torch.where(do_pivot, z, s.last_z)
    bland = s.bland | (stuck >= stall_limit)

    finite_ok = (
        torch.isfinite(z)
        & torch.isfinite(rhsn[2:].abs().sum())
        & torch.isfinite(lay.psum(
            torch.where(s.col_active, crow.abs(), 0.0).sum())))
    new_status = torch.where(
        ~finite_ok, Status.NUMERIC,
        torch.where(became_infeasible, Status.INFEASIBLE,
                    torch.where(became_optimal, Status.OPTIMAL,
                                Status.RUNNING))).to(torch.int32)
    status = torch.where(running, new_status, s.status)

    return ShardedState(
        T=Tn,
        rhs=rhsn,
        basis=basis,
        col_active=s.col_active,
        art_cols=s.art_cols,
        phase=s.phase,
        status=status,
        niter=s.niter + do_pivot.to(torch.int32),
        stuck=stuck,
        bland=bland,
        last_z=last_z,
    )


def run_dual_batch_sharded(sh: ShardedState, lay, opts: SolverOptions,
                           stall_limit: int,
                           max_iters: Optional[int] = None) -> ShardedState:
    """The dual step vmapped over the local lanes of ``sh`` until no lane
    runs below ``max_iters`` (default ``opts.max_iters``)."""
    max_iters = opts.max_iters if max_iters is None else max_iters
    return run_lanes(
        lambda s: _sharded_dual_step(s, opts, stall_limit, lay, max_iters),
        sh, max_iters)


class LaneMesh:
    """A mesh resolved for lane-sharded solving: the ``batch`` axis
    (``None``: every process holds every lane) and the ``cols`` axis
    (absent from the mesh: columns whole, ``WHOLE``)."""

    def __init__(self, mesh, batch_axis: Optional[str] = "batch",
                 cols_axis: Optional[str] = "cols"):
        names = tuple(mesh.mesh_dim_names or ())
        if batch_axis is not None and batch_axis not in names:
            raise ValueError(f"the mesh has no {batch_axis!r} axis (its "
                             f"axes are {names})")
        self.mesh = mesh
        self.batch_axis = batch_axis
        self.lay_b = MeshAxis(mesh, batch_axis) \
            if batch_axis is not None else None
        self.lay_c = MeshAxis(mesh, cols_axis) \
            if cols_axis is not None and cols_axis in names else WHOLE

    @property
    def batch(self) -> int:
        return self.lay_b.size if self.lay_b is not None else 1

    # ---- layout --------------------------------------------------------
    def block(self, x: torch.Tensor, value=False) -> torch.Tensor:
        """This shard's column block of a full-width last axis (padded with
        ``value`` to a multiple of the shard count)."""
        return _local_block(
            _pad_cols(x, (-x.shape[-1]) % self.lay_c.size, value),
            self.lay_c)

    def to_frames(self, st: SimplexState) -> SimplexState:
        """A full-width state (any leading lane axes) as this shard's
        frames: the coefficient block padded with zero, inactive,
        non-artificial columns and sliced, the RHS column appended."""
        return SimplexState(
            torch.cat([self.block(st.T[..., :-1], 0.0),
                       st.T[..., -1:]], dim=-1),
            st.basis, self.block(st.col_active), self.block(st.art_cols),
            *st[4:])

    def from_frames(self, fr: SimplexState, n: int) -> SimplexState:
        """The whole state on every process of the ``cols`` group: the
        blocks gathered and cut to ``n`` columns, the RHS re-attached."""
        lay = self.lay_c
        return SimplexState(
            torch.cat([_gather_cols(fr.T[..., :-1], lay, n), fr.T[..., -1:]],
                      dim=-1),
            fr.basis, _gather_cols(fr.col_active, lay, n),
            _gather_cols(fr.art_cols, lay, n), *fr[4:])

    def mine(self, st):
        """This process's lanes of a state (or tensor) with every lane:
        the ``batch`` shard's contiguous share, in lane order."""
        lanes = (st.T if isinstance(st, tuple) else st).shape[0]
        if lanes % self.batch:
            raise ValueError(f"{lanes} lanes do not split over the "
                             f"{self.batch_axis!r} axis of {self.batch} "
                             "shards")
        k = lanes // self.batch
        lo = (self.lay_b.index if self.lay_b is not None else 0) * k
        if isinstance(st, tuple):
            return type(st)(*(x[lo:lo + k] for x in st))
        return st[lo:lo + k]

    def gather(self, st: SimplexState) -> SimplexState:
        """Every ``batch`` shard's lanes of ``st`` on every process, in
        lane order: ONE all_gather of all fields packed in T's dtype (the
        integer fields are exact in it)."""
        if self.lay_b is None:
            return st
        L = st.T.shape[0]
        dt = st.T.dtype
        flat = [x.reshape(L, -1) for x in st]
        packed = torch.cat([x.to(dt) for x in flat], dim=1)
        g = self.lay_b.all_gather(packed)
        g = g.reshape(g.shape[0] * L, -1)
        out, at = [], 0
        for x, f in zip(st, flat):
            w = f.shape[1]
            part = g[:, at:at + w].reshape((-1,) + tuple(x.shape[1:]))
            out.append(part != 0 if x.dtype == torch.bool
                       else part.to(x.dtype))
            at += w
        return SimplexState(*out)

    # ---- drivers on frames: whole frames are solo states ----------------
    def primal(self, fr: SimplexState, opts: SolverOptions,
               stall_limit: int, max_iters: Optional[int] = None
               ) -> SimplexState:
        if self.lay_c is WHOLE:
            max_iters = opts.max_iters if max_iters is None else max_iters
            return primal_lanes(fr, opts, stall_limit, max_iters)
        return join_frames(run_simplex_batch_sharded(
            split_frames(fr), self.lay_c, opts, stall_limit, max_iters))

    def dual(self, fr: SimplexState, opts: SolverOptions, stall_limit: int,
             max_iters: Optional[int] = None) -> SimplexState:
        if self.lay_c is WHOLE:
            max_iters = opts.max_iters if max_iters is None else max_iters
            return dual_lanes(fr, opts, stall_limit, max_iters)
        return join_frames(run_dual_batch_sharded(
            split_frames(fr), self.lay_c, opts, stall_limit, max_iters))

    def dual_then_primal(self, fr: SimplexState, opts: SolverOptions,
                         stall_limit: int, max_iters: int) -> SimplexState:
        """``solve.dual._dual_then_primal`` on this process's lanes."""
        fr = self.dual(fr, opts, stall_limit, max_iters)
        fr = fr._replace(status=torch.where(
            fr.status == Status.OPTIMAL, Status.RUNNING, fr.status))
        return finish(self.primal(fr, opts, stall_limit, max_iters))

    def column(self, T: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
        """``T[k, :, cols[k]]`` for frames ``T`` and global coefficient
        columns ``cols``: each owner contributes its column, one psum over
        ``cols`` carries every lane."""
        w = T.shape[-1] - 1
        owner = (cols // w) == self.lay_c.index
        lanes = torch.arange(T.shape[0], device=T.device)
        local = T[lanes, :, (cols % w).long()]
        return self.lay_c.psum(torch.where(owner[:, None], local, 0.0))

"""Sharded bounded-variable simplex: spans in the ratio test, multi-process.

The counterpart of ``tpulp.shard.sharded_bounded``: the state machine of
``solve/bounded.py`` (flips instead of bound rows) over the column-sharded
layout of ``shard/sharded.py``, Dantzig- or Bland-priced:

* ``upper`` and ``at_upper`` are split like the tableau's columns;
* the basic spans ``upper[basis]`` take one (m,) psum per step, and the
  entering column's fetch carries its span as one more psum lane;
* the three-way ratio test (a basic variable hits 0, a basic variable hits
  its own span, the entering variable crosses its whole span) runs on
  replicated vectors;
* a flip needs no collective: an entering flip's column is the one just
  fetched, and the leaving column's post-pivot value is closed form (it
  was the unit vector on row rg: ``-u / piv`` off that row, ``1 / piv`` on
  it); its owner negates its slice, and every shard folds the RHS with one
  fma an entry (tpulp's XLA contracts that update to one rounding). The
  pivot, its gate and the flip are one pass over the block
  (``kernels.shard_pivot``).

An idle step pivots on (row 2, ``basis[0]``) with that column's unit
vector built locally, as in ``shard/sharded.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..comm.collectives import MeshAxis
from ..core.state import SolverOptions, Status
from ..kernels.shard_pivot import Flip, shard_pivot
from ..solve.bounded import BoundedState
from ..solve.driver import (BIG_I, finish, put, run_chunked, status_select,
                             take)
from .sharded import (ShardedState, _axis_size, _check_device, _gather_cols,
                      _local_block, _pad_cols, art_basic_scan,
                      cleanup_and_price, from_sharded_state,
                      to_sharded_state, unit_row2)

__all__ = ["ShardedBoundedState", "to_sharded_bounded_state",
           "from_sharded_bounded_state", "run_simplex_sharded_bounded"]


class ShardedBoundedState(NamedTuple):
    s: ShardedState
    upper: torch.Tensor     # (n_local,) this shard's spans (or +inf)
    at_upper: torch.Tensor  # (n_local,) bool, this shard's


def to_sharded_bounded_state(bs: BoundedState, mesh, axis="cols"
                             ) -> ShardedBoundedState:
    """This process's shard of a solo BoundedState (spans padded with
    +inf)."""
    lay = MeshAxis(mesh, axis)
    pad = (-bs.s.n) % _axis_size(mesh, axis)
    return ShardedBoundedState(
        s=to_sharded_state(bs.s, mesh, axis=axis),
        upper=_local_block(_pad_cols(bs.upper, pad, float("inf")), lay),
        at_upper=_local_block(_pad_cols(bs.at_upper, pad, False), lay),
    )


def from_sharded_bounded_state(sb: ShardedBoundedState, n: int, mesh,
                               axis="cols") -> BoundedState:
    """The whole BoundedState on every process (padding dropped)."""
    lay = MeshAxis(mesh, axis)
    return BoundedState(
        s=from_sharded_state(sb.s, n, mesh, axis),
        upper=_gather_cols(sb.upper, lay, n),
        at_upper=_gather_cols(sb.at_upper, lay, n),
    )


def _fetch_column_and_span(T_local, upper, j, lay: MeshAxis):
    """The entering column and its span in ONE (m+3)-psum."""
    n_local = T_local.shape[1]
    owner = (j // n_local) == lay.index
    j_local = j % n_local
    contrib = torch.cat([take(T_local, j_local, 1),
                         take(upper, j_local)[None]])
    out = lay.psum(torch.where(owner, contrib, 0.0))
    return out[:-1], out[-1]


def _sharded_bounded_step(sb: ShardedBoundedState, opts: SolverOptions,
                          stall_limit: int, n_global: int, lay: MeshAxis,
                          max_iters: int | None = None
                          ) -> ShardedBoundedState:
    """One branchless transition: ``bounded_simplex_step`` (and tpulp's
    ``_sharded_bounded_step``) over the sharded layout. With ``max_iters``
    the step is a no-op once ``niter`` reaches it."""
    s = sb.s
    T = s.T
    nrows, n_local = T.shape
    inf = float("inf")
    running = s.status == Status.RUNNING
    if max_iters is not None:
        running = running & (s.niter < max_iters)
    in_phase2 = s.phase == 2
    basis_l = s.basis.long()
    owner_b = (basis_l // n_local) == lay.index

    # ---- cleanup scan and pricing, as the rank-1 sharded driver's (uniform
    # under the complement representation) ----------------------------------
    crow = torch.where(s.phase == 1, T[1], T[0])
    (cleanup, r_d, j_d, has_elig, art_cols, j_price, has_improving,
     use_bland) = cleanup_and_price(
        s, art_basic_scan(s, lay), lambda r: take(T, r + 2, 0), crow,
        running, opts, n_global, lay)

    # ---- phase bookkeeping -----------------------------------------------
    z1 = -s.rhs[1]
    phase1_done = (s.phase == 1) & ~has_improving & running
    became_infeasible = phase1_done & (z1 > opts.infeas_tol)
    to_phase2 = phase1_done & ~became_infeasible
    pricing_pivot = has_improving & ~cleanup & ~phase1_done

    # ---- basic spans: one (m,) psum (owners contribute their entries) ----
    u_basic = lay.psum(torch.where(owner_b, sb.upper[basis_l % n_local],
                                   0.0))

    # ---- entering column and its span, one psum --------------------------
    j = torch.where(cleanup, j_d, j_price)
    u, upper_j = _fetch_column_and_span(T, sb.upper, j, lay)
    col = u[2:]
    b = s.rhs[2:]
    # (a) a basic variable hits 0
    pos = col > opts.piv_tol
    t_lo = torch.where(pos, b / torch.where(pos, col, 1.0), inf)
    t_lo_min = t_lo.min()
    # (b) a basic variable hits its own span
    neg = (col < -opts.piv_tol) & torch.isfinite(u_basic)
    t_up = torch.where(neg, (u_basic - b) / torch.where(neg, -col, 1.0), inf)
    t_up_min = t_up.min()
    # (c) the entering variable crosses its whole span
    t_star = torch.minimum(torch.minimum(t_lo_min, t_up_min), upper_j)
    has_ratio = torch.isfinite(t_star)
    kind_lo = t_lo_min <= t_star
    kind_up = ~kind_lo & (t_up_min <= t_star)
    kind_flip = ~kind_lo & ~kind_up

    tie = torch.where(kind_lo, t_lo <= t_star, neg & (t_up <= t_star))
    r_first = torch.argmax(tie.to(torch.int32))
    r_bland = torch.argmin(torch.where(tie, s.basis, BIG_I))
    r_price = torch.where(use_bland, r_bland, r_first)

    became_unbounded = pricing_pivot & ~has_ratio & in_phase2 & running
    became_failed1 = pricing_pivot & ~has_ratio & ~in_phase2 & running

    # ---- the one (possibly no-op) pivot ------------------------------------
    do_cleanup = cleanup & has_elig
    do_price = pricing_pivot & has_ratio & running
    do_pivot = do_cleanup | (do_price & ~kind_flip)
    do_flip_enter = do_price & kind_flip
    r = torch.where(do_cleanup, r_d, r_price)
    leaving = take(basis_l, r)
    rg = torch.where(do_pivot, r + 2, 2)
    j_eff = torch.where(do_pivot, j.long(), basis_l[0])
    u_eff = torch.where(do_pivot, u, unit_row2(nrows, T))
    basis = torch.where(do_pivot, put(s.basis, r, j), s.basis)

    # ---- the one (possibly no-op) column flip, in the pivot's pass --------
    do_flip = (do_price & kind_up & ~cleanup) | do_flip_enter
    fcol = torch.where(do_flip_enter, j.long(), leaving)
    uf = torch.where(do_flip, torch.where(do_flip_enter, upper_j,
                                          take(u_basic, r)), 0.0)
    Tn, rhsn = shard_pivot(T, s.rhs, u_eff, rg, j_eff, lay.index, do_pivot,
                           Flip(do_flip, do_flip_enter, fcol, uf, u))
    is_fcol = (((fcol // n_local) == lay.index)
               & (torch.arange(n_local, device=T.device) == fcol % n_local)
               & do_flip)
    at_upper = torch.where(is_fcol, ~sb.at_upper, sb.at_upper)

    # ---- stall / Bland switch ----------------------------------------------
    act = do_pivot | do_flip_enter
    z = torch.where(s.phase == 1, -rhsn[1], -rhsn[0])
    improved = (s.last_z - z) > opts.degen_tol
    stuck = torch.where(do_price & act,
                        torch.where(improved, 0, s.stuck + 1),
                        s.stuck).to(torch.int32)
    last_z = torch.where(do_price & act, z, s.last_z)
    bland = s.bland | (stuck >= stall_limit)

    phase = torch.where(to_phase2, 2, s.phase).to(torch.int32)
    col_active = torch.where(to_phase2, s.col_active & ~art_cols,
                             s.col_active)
    stuck = torch.where(to_phase2, 0, stuck).to(torch.int32)
    last_z = torch.where(to_phase2, inf, last_z)

    finished_opt = in_phase2 & ~has_improving & ~cleanup & running
    finite_ok = (
        torch.isfinite(z)
        & torch.isfinite(rhsn[2:].abs().sum())
        & torch.isfinite(lay.psum(
            torch.where(s.col_active, crow.abs(), 0.0).sum())))
    new_status = status_select(finite_ok, became_infeasible | became_failed1,
                               became_unbounded, finished_opt)
    status = torch.where(running, new_status, s.status)

    return ShardedBoundedState(
        s=ShardedState(
            T=Tn,
            rhs=rhsn,
            basis=basis,
            col_active=col_active,
            art_cols=art_cols,
            phase=phase,
            status=status,
            niter=s.niter + act.to(torch.int32),
            stuck=stuck,
            bland=bland,
            last_z=last_z,
        ),
        upper=sb.upper,
        at_upper=at_upper,
    )


def run_simplex_sharded_bounded(sb: ShardedBoundedState, mesh,
                                opts: SolverOptions | None = None,
                                axis="cols") -> ShardedBoundedState:
    """Run the sharded bounded-variable driver to termination or
    ``opts.max_iters`` (every process calls it with its own shard)."""
    if opts is None:
        opts = SolverOptions.for_dtype(sb.s.T.dtype)
    _check_device(sb.s.T, mesh)
    lay = MeshAxis(mesh, axis)
    m = sb.s.basis.shape[0]
    n_global = sb.s.T.shape[1] * lay.size
    stall_limit = opts.resolved_stall_limit(m, n_global)
    out = run_chunked(
        lambda c: _sharded_bounded_step(c, opts, stall_limit, n_global, lay,
                                        opts.max_iters),
        sb, lambda c: c.s, opts.max_iters)
    return out._replace(s=finish(out.s))

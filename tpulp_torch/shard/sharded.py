"""Column-partitioned simplex over a device mesh, one process per shard.

The counterpart of path B of ``tpulp.shard.sharded`` (the explicit
``shard_map`` driver with hand-placed collectives). The tableau's columns
(its big axis, SURVEY.md §5) are split into contiguous blocks over a mesh
axis; every process holds its (m+2, n/P) block, and the RHS column, the
basis and the scalars replicated. Per pivot:

1. cleanup scan: an (m,) psum marks the basic artificials;
2. pricing: each shard reduces its reduced costs to a (value, index)
   candidate, its first improving column (Bland) and its first
   cleanup-eligible column; ONE all_gather of the P packed candidates
   (``gather_candidates``), a replicated argmin (first minimum in shard
   order, so first-index ties hold across shards) and minima over the
   first columns pick the entering column (tpulp makes two all_gathers
   and two pmins of them);
3. the entering column: its owner contributes it, the others zeros, and
   one (m+2)-psum broadcasts it;
4. the ratio test runs replicated, and the rank-1 update on each shard's
   block is local, one rounding per element (``fused_fma``).

torch.distributed is multi-controller: every process runs this driver
with the same program, and every host-side decision (the chunk loop's
status read) comes from replicated values, so no process leaves a loop
another is still in. Where tpulp redirects an idle step to a second
column fetch under ``lax.cond``, this driver builds that column locally:
``basis[0]``'s column is the exact unit vector on row 2, so the idle step
costs no collective that only some processes would call, and leaves the
block bit for bit.

``make_mesh`` returns a ``torch.distributed`` ``DeviceMesh``; GSPMD's path
A (``shard_state``, ``run_simplex_gspmd`` and the batched forms) has no
counterpart yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from ..comm.collectives import MeshAxis, axis_size
from ..core.state import RULE_BLAND, SimplexState, SolverOptions, Status
from ..kernels.fma import fused_fma
from ..solve.driver import (BIG_I, finish, put, ratio_rows, run_chunked,
                             status_select, take)

__all__ = [
    "ShardedState",
    "to_sharded_state",
    "from_sharded_state",
    "run_simplex_sharded",
    "make_mesh",
]


def make_mesh(n_devices: Optional[int] = None, axis: str = "cols",
              device: str = "cuda"):
    """A 1-D ``DeviceMesh`` named ``axis`` over the processes of the
    default group, one device each; ``n_devices`` must equal the group's
    size (each process holds one shard). Bring the group up first
    (``tpulp_torch.comm.init_distributed``)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group of one process "
                           "per device: call tpulp_torch.comm."
                           "init_distributed first")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh({n_devices}): the process group has "
                         f"{world} processes, one per shard")
    return init_device_mesh(torch.device(device).type, (world,),
                            mesh_dim_names=(axis,))


def _axis_size(mesh, axis) -> int:
    """Shard count along ``axis``: a mesh axis name, or the tuple of every
    axis (the ``(hosts, cols)`` layout, columns split host-major)."""
    return axis_size(mesh, axis)


class ShardedState(NamedTuple):
    """This process's part of a column-sharded SimplexState: its (m+2,
    n/P) coefficient block and its slice of the column masks; the RHS
    column, the basis and the scalars are replicated, updated identically
    on every process."""

    T: torch.Tensor           # (m+2, n_local) this shard's block
    rhs: torch.Tensor         # (m+2,) replicated: [-z2, -z1, b...]
    basis: torch.Tensor       # (m,) int32, replicated
    col_active: torch.Tensor  # (n_local,) this shard's
    art_cols: torch.Tensor    # (n_local,) this shard's
    phase: torch.Tensor
    status: torch.Tensor
    niter: torch.Tensor
    stuck: torch.Tensor
    bland: torch.Tensor
    last_z: torch.Tensor


def _check_device(t: torch.Tensor, mesh) -> None:
    if t.device.type != mesh.device_type:
        raise ValueError(f"the state lies on {t.device} and the mesh's "
                         f"devices are {mesh.device_type!r}")


def _pad_cols(x: torch.Tensor, pad: int, value) -> torch.Tensor:
    """``x`` with ``pad`` columns of ``value`` appended on its last axis."""
    if not pad:
        return x
    fill = torch.full(x.shape[:-1] + (pad,), value, dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, fill], dim=-1)


def _local_block(x: torch.Tensor, lay: MeshAxis) -> torch.Tensor:
    """This shard's contiguous slice of the last axis, as its own tensor."""
    n_local = x.shape[-1] // lay.size
    lo = lay.index * n_local
    return x[..., lo:lo + n_local].clone()


def to_sharded_state(state: SimplexState, mesh, axis="cols"
                     ) -> ShardedState:
    """This process's shard of ``state`` (which every process holds
    whole): columns padded to a multiple of the shard count with zero,
    inactive, non-artificial columns, the block and masks sliced, the rest
    copied. ``axis`` may be the tuple of every mesh axis."""
    _check_device(state.T, mesh)
    lay = MeshAxis(mesh, axis)
    pad = (-state.n) % _axis_size(mesh, axis)
    return ShardedState(
        T=_local_block(_pad_cols(state.T[:, :-1], pad, 0.0), lay),
        rhs=state.T[:, -1].clone(),
        basis=state.basis.clone(),
        col_active=_local_block(_pad_cols(state.col_active, pad, False), lay),
        art_cols=_local_block(_pad_cols(state.art_cols, pad, False), lay),
        phase=state.phase.clone(),
        status=state.status.clone(),
        niter=state.niter.clone(),
        stuck=state.stuck.clone(),
        bland=state.bland.clone(),
        last_z=state.last_z.clone(),
    )


def _gather_cols(x: torch.Tensor, lay: MeshAxis, n: int) -> torch.Tensor:
    """Every shard's block of ``x`` joined along the last axis, cut to
    ``n`` columns (the padding dropped)."""
    parts = lay.all_gather(x)
    return torch.cat(list(parts.unbind(0)), dim=-1)[..., :n]


def from_sharded_state(sh: ShardedState, n: int, mesh, axis="cols"
                       ) -> SimplexState:
    """The whole SimplexState on every process: the blocks gathered over
    ``axis`` and the column padding dropped."""
    lay = MeshAxis(mesh, axis)
    return SimplexState(
        T=torch.cat([_gather_cols(sh.T, lay, n), sh.rhs[:, None]], dim=1),
        basis=sh.basis,
        col_active=_gather_cols(sh.col_active, lay, n),
        art_cols=_gather_cols(sh.art_cols, lay, n),
        phase=sh.phase,
        status=sh.status,
        niter=sh.niter,
        stuck=sh.stuck,
        bland=sh.bland,
        last_z=sh.last_z,
    )


def local_ids(n_local: int, lay: MeshAxis, device) -> torch.Tensor:
    """The global indices of this shard's columns."""
    return (torch.arange(n_local, dtype=torch.int32, device=device)
            + lay.index * n_local)


def _fetch_column(T_local: torch.Tensor, j: torch.Tensor, lay: MeshAxis):
    """The entering column, replicated: its owner contributes it, the
    others zeros, one (m+2)-psum."""
    n_local = T_local.shape[1]
    owner = (j // n_local) == lay.index
    return lay.psum(torch.where(owner, take(T_local, j % n_local, 1), 0.0))


def art_basic_scan(s: ShardedState, lay: MeshAxis) -> torch.Tensor:
    """(m,) bool, replicated: whether each basic column is artificial. The
    owner of each basic column contributes its flag; one (m,) int32 psum."""
    n_local = s.T.shape[1]
    basis_l = s.basis.long()
    owner_b = (basis_l // n_local) == lay.index
    flags = s.art_cols[basis_l % n_local].to(torch.int32)
    return lay.psum(torch.where(owner_b, flags, 0)) > 0


def gather_candidates(val, arg, first, first_elig, lay: MeshAxis):
    """Every shard's pricing and cleanup candidates in ONE all_gather: its
    best (value, global column) pair, its first improving column and its
    first cleanup-eligible column, carried as float64, which holds the
    f32 and f64 values and the column indices exactly. Returns, replicated,
    the (P,) values in ``val``'s dtype and the (P,) int32 columns in shard
    order, and the two first columns' minima over the shards (int32)."""
    g = lay.all_gather(torch.stack([val.double(), arg.double(),
                                    first.double(), first_elig.double()]))
    return (g[:, 0].to(val.dtype), g[:, 1].to(torch.int32),
            g[:, 2].min().to(torch.int32), g[:, 3].min().to(torch.int32))


def retire_dependent(s: ShardedState, cleanup, r_d, j_d, n_global: int,
                     lay: MeshAxis):
    """The cleanup decisions from the first eligible column ``j_d`` over
    the shards (BIG_I where there is none): (has_elig, retire, j_d
    clamped, art_cols). A dependent row's artificial is retired by the
    shard that owns it."""
    n_local = s.T.shape[1]
    has_elig = j_d < BIG_I
    retire = cleanup & ~has_elig
    basis_rd = take(s.basis.long(), r_d)
    owner_rd = (basis_rd // n_local) == lay.index
    art_cols = torch.where(retire & owner_rd,
                           put(s.art_cols, basis_rd % n_local, False),
                           s.art_cols)
    return has_elig, retire, torch.clamp_max(j_d, n_global - 1), art_cols


def cleanup_and_price(s: ShardedState, art_basic, row_of, crow, running,
                      opts, n_global: int, lay: MeshAxis):
    """The cleanup scan and Dantzig/Bland pricing over the shards, from
    one ``gather_candidates``: (cleanup, r_d, j_d, has_elig, art_cols,
    j_price, has_improving, use_bland). ``art_basic`` is replicated;
    ``row_of(r_d)`` is the local slice of the cleanup row."""
    n_local = s.T.shape[1]
    ids = local_ids(n_local, lay, s.T.device)
    cleanup = art_basic.any() & (s.phase == 2) & running
    r_d = torch.argmax(art_basic.to(torch.int32))
    elig = s.col_active & ~s.art_cols & (row_of(r_d).abs() > opts.piv_tol)
    c_eff = torch.where(s.col_active, crow, float("inf"))
    improving = c_eff < -opts.opt_tol
    g_vals, g_idxs, j_bland, j_d = gather_candidates(
        c_eff.min(), torch.argmin(c_eff) + lay.index * n_local,
        torch.where(improving, ids, n_global).min(),
        torch.where(elig, ids, BIG_I).min(), lay)
    k = torch.argmin(g_vals)  # the first minimum, in shard order
    has_improving = take(g_vals, k) < -opts.opt_tol
    use_bland = s.bland | (opts.rule == RULE_BLAND)
    j_price = torch.where(use_bland, torch.clamp_max(j_bland, n_global - 1),
                          take(g_idxs, k))
    has_elig, _, j_d, art_cols = retire_dependent(s, cleanup, r_d, j_d,
                                                  n_global, lay)
    return (cleanup, r_d, j_d, has_elig, art_cols, j_price, has_improving,
            use_bland)


def pivot_local(T, rhs, u_eff, rg, owner_eff, j_local_eff):
    """The rank-1 pivot on this shard's block and the replicated RHS: row
    ``rg`` normalised, ``T - u (x) prow`` with one rounding per element,
    the entering column (on its owner) snapped to the unit vector."""
    nrows, n_local = T.shape
    invp = 1.0 / take(u_eff, rg)
    prow = take(T, rg, 0) * invp
    Tn = fused_fma(T, u_eff[:, None], prow[None, :], -1.0)
    is_rg = (torch.arange(nrows, device=T.device) == rg)[:, None]
    Tn = torch.where(is_rg, prow[None, :], Tn)
    is_j = owner_eff & (torch.arange(n_local, device=T.device)
                        == j_local_eff)
    Tn = torch.where(is_j[None, :], is_rg.to(T.dtype), Tn)
    rhs_piv = take(rhs, rg) * invp
    rhsn = put(fused_fma(rhs, u_eff, rhs_piv, -1.0), rg, rhs_piv)
    return Tn, rhsn, invp


def unit_row2(nrows: int, like: torch.Tensor) -> torch.Tensor:
    """The column of ``basis[0]``: the exact unit vector on row 2."""
    return (torch.arange(nrows, device=like.device) == 2).to(like.dtype)


def _sharded_step(s: ShardedState, opts: SolverOptions, stall_limit: int,
                  n_global: int, lay: MeshAxis,
                  max_iters: int | None = None) -> ShardedState:
    """One branchless transition; the decisions of ``simplex_step`` (and
    of tpulp's ``_sharded_step``) over the column-sharded layout. With
    ``max_iters`` the step is a no-op once ``niter`` reaches it."""
    T = s.T
    inf = float("inf")
    running = s.status == Status.RUNNING
    if max_iters is not None:
        running = running & (s.niter < max_iters)
    in_phase2 = s.phase == 2

    # ---- cleanup scan and pricing: per-shard candidates, one gather -------
    crow = torch.where(s.phase == 1, T[1], T[0])
    (cleanup, r_d, j_d, has_elig, art_cols, j_price, has_improving,
     use_bland) = cleanup_and_price(
        s, art_basic_scan(s, lay), lambda r: take(T, r + 2, 0), crow,
        running, opts, n_global, lay)

    # ---- phase bookkeeping --------------------------------------------------
    z1 = -s.rhs[1]
    phase1_done = (s.phase == 1) & ~has_improving & running
    became_infeasible = phase1_done & (z1 > opts.infeas_tol)
    to_phase2 = phase1_done & ~became_infeasible
    pricing_pivot = has_improving & ~cleanup & ~phase1_done

    # ---- entering column by psum, replicated ratio test --------------------
    j = torch.where(cleanup, j_d, j_price)
    u = _fetch_column(T, j, lay)
    has_ratio, r_price = ratio_rows(u[2:], s.rhs[2:], s.basis,
                                    opts.piv_tol, use_bland)
    became_unbounded = pricing_pivot & ~has_ratio & in_phase2 & running
    became_failed1 = pricing_pivot & ~has_ratio & ~in_phase2 & running

    # ---- the one pivot (the exact no-op on (row 2, basis[0]) when idle) ---
    do_cleanup = cleanup & has_elig
    do_pricing = pricing_pivot & has_ratio & running
    do_pivot = do_cleanup | do_pricing
    r = torch.where(do_cleanup, r_d, r_price)
    rg = torch.where(do_pivot, r + 2, 2)
    j_eff = torch.where(do_pivot, j.long(), s.basis[0].long())
    u_eff = torch.where(do_pivot, u, unit_row2(T.shape[0], T))
    n_local = T.shape[1]
    Tn, rhsn, _ = pivot_local(T, s.rhs, u_eff, rg,
                              (j_eff // n_local) == lay.index,
                              j_eff % n_local)
    basis = torch.where(do_pivot, put(s.basis, r, j), s.basis)

    # ---- stall / Bland switch -----------------------------------------------
    z = torch.where(s.phase == 1, -rhsn[1], -rhsn[0])
    improved = (s.last_z - z) > opts.degen_tol
    stuck = torch.where(do_pricing,
                        torch.where(improved, 0, s.stuck + 1),
                        s.stuck).to(torch.int32)
    last_z = torch.where(do_pricing, z, s.last_z)
    bland = s.bland | (stuck >= stall_limit)

    # ---- phase transition + termination -------------------------------------
    phase = torch.where(to_phase2, 2, s.phase).to(torch.int32)
    col_active = torch.where(to_phase2, s.col_active & ~art_cols,
                             s.col_active)
    stuck = torch.where(to_phase2, 0, stuck).to(torch.int32)
    last_z = torch.where(to_phase2, inf, last_z)

    finished_opt = in_phase2 & ~has_improving & ~cleanup & running
    # a NaN pricing entry anywhere reads NUMERIC on every shard: the
    # pricing row's check needs a psum, the replicated RHS does not
    finite_ok = (
        torch.isfinite(z)
        & torch.isfinite(rhsn[2:].abs().sum())
        & torch.isfinite(lay.psum(
            torch.where(s.col_active, crow.abs(), 0.0).sum())))
    new_status = status_select(finite_ok, became_infeasible | became_failed1,
                           became_unbounded, finished_opt)
    status = torch.where(running, new_status, s.status)

    return ShardedState(
        T=Tn,
        rhs=rhsn,
        basis=basis,
        col_active=col_active,
        art_cols=art_cols,
        phase=phase,
        status=status,
        niter=s.niter + do_pivot.to(torch.int32),
        stuck=stuck,
        bland=bland,
        last_z=last_z,
    )


def run_simplex_sharded(sh: ShardedState, mesh,
                        opts: SolverOptions | None = None,
                        axis="cols") -> ShardedState:
    """Run the rank-1 sharded driver to termination or ``opts.max_iters``
    (every process of the mesh calls it with its own shard)."""
    if opts is None:
        opts = SolverOptions.for_dtype(sh.T.dtype)
    _check_device(sh.T, mesh)
    lay = MeshAxis(mesh, axis)
    m = sh.basis.shape[0]
    n_global = sh.T.shape[1] * lay.size
    stall_limit = opts.resolved_stall_limit(m, n_global)
    out = run_chunked(
        lambda s: _sharded_step(s, opts, stall_limit, n_global, lay,
                                opts.max_iters),
        sh, lambda s: s, opts.max_iters)
    return finish(out)

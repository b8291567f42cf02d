"""The branch-and-bound wave engines over a ``(batch, cols)`` mesh.

``solve_milp(mesh=...)`` runs the same scheduler as on one device; only
its wave engines change. ``MeshWaves`` has the solo engines' signatures
(``solve/dual.py``: ``run_warm_batch``, ``run_warm_wave``,
``run_expand_generation``; the cold wave of ``run_simplex_batch``) over
the layout of ``shard/sharded_batch.py``:

* the node template, the state pool and every wave's terminal state are
  *frames*: each lane's coefficient block of this ``cols`` shard with its
  RHS column appended, replicated over ``batch``;
* a wave solves only this process's lanes (its ``batch`` shard's share),
  with the lane-sharded dual and primal steps, and ends in ONE packed
  ``all_gather`` over ``batch`` that brings every lane's terminal frame,
  basis and status home on every process. The frames the scheduler parks
  in the pool, a deferred write of the next wave and a device
  generation's parents are then local reads, wherever their lane ran;
* a child's sparse RHS rewrite ``b += coef * T[:, col]`` reads one column
  that a single ``cols`` shard owns: one psum over ``cols`` carries every
  local lane's column;
* the summaries (``solve.dual._wave_summaries``) are computed from the
  gathered wave at the full batch width, so the host reads the same bits
  on every process, and the same bits as the solo waves'.

Every process runs the same scheduler on these replicated values, so no
process branches alone (a lone branch would deadlock the next
collective). The stall limits derive from the template's logical width,
padded to the ``cols`` size, as tpulp's mesh waves do.
"""

from __future__ import annotations

import torch

from ..comm.collectives import MeshAxis
from ..core.precision import full_precision
from ..core.state import SimplexState, SolverOptions
from ..kernels.fma import fused_fma
from ..solve.driver import finish
from ..solve.dual import (_frames, _ints, _lanes, _wave_summaries,
                          expand_plan, genealogy_summary, pool_write)
from .sharded_batch import LaneMesh

__all__ = ["MeshWaves", "any_process"]


def any_process(mesh, flag: bool) -> bool:
    """``flag`` or-ed over every process of ``mesh``: one pmax over all of
    its axes."""
    lay = MeshAxis(mesh, tuple(mesh.mesh_dim_names))
    t = torch.tensor([int(flag)], dtype=torch.int32,
                     device=torch.device(mesh.device_type))
    return bool(lay.pmax(t).item())


class MeshWaves(LaneMesh):
    """The wave engines of one ``solve_milp(mesh=...)``; ``n`` is the
    template's logical column count (its padded width less one)."""

    def __init__(self, mesh, n: int, batch_axis: str = "batch",
                 cols_axis: str = "cols"):
        super().__init__(mesh, batch_axis, cols_axis)
        self.n = n

    def _stall(self, opts: SolverOptions, m: int) -> int:
        return opts.resolved_stall_limit(m, self.n)

    def _rewrite(self, T, cols, coef) -> torch.Tensor:
        """``solve.dual._rhs_rewrite`` on frames, in place: the rewrite
        column from its owner."""
        T[:, :, -1] = fused_fma(T[:, :, -1], coef[:, None],
                                self.column(T, cols))
        return T

    @full_precision()
    def cold_wave(self, batched: SimplexState, opts: SolverOptions
                  ) -> SimplexState:
        """``run_simplex_batch`` of a refreshed template (frames of every
        lane): this process's lanes, gathered."""
        out = self.primal(self.mine(batched), opts,
                          self._stall(opts, batched.T.shape[1] - 2))
        return self.gather(finish(out))

    @full_precision()
    def run_warm_batch(self, A_aug, c_full, col_active, art_cols,
                       basis_mat, b_mat, opts: SolverOptions | None = None
                       ) -> SimplexState:
        """``solve.dual.run_warm_batch`` from the full-width root frame
        (``A_aug``, ``c_full`` and the masks of the padded template):
        every lane's frame is built at the full width on every process,
        as the solo wave builds them, the lanes padded to the batch axis
        by replicating lane 0; this process's lanes are solved and the
        wave gathered, cut back to its lanes."""
        if opts is None:
            opts = SolverOptions.for_dtype(A_aug.dtype)
        dev = A_aug.device
        L = len(basis_mat)
        basis_mat = _ints(basis_mat, dev)
        b_mat = torch.as_tensor(b_mat, dtype=A_aug.dtype, device=dev)
        st = _lanes(_frames(A_aug, c_full, basis_mat, b_mat), basis_mat,
                    col_active, art_cols)
        pad = (-L) % self.batch
        if pad:
            st = SimplexState(*(torch.cat([x, x[:1].expand(
                (pad,) + tuple(x.shape[1:]))]) for x in st))
        out = self.dual_then_primal(self.to_frames(self.mine(st)), opts,
                                    self._stall(opts, A_aug.shape[0]),
                                    opts.max_iters)
        return SimplexState(*(x[:L] for x in self.gather(out)))

    @full_precision()
    def run_warm_wave(self, pool_T, pool_basis, col_active, art_cols,
                      prev_T, prev_basis, ipack, R, const, max_iters: int,
                      opts: SolverOptions | None = None):
        """``solve.dual.run_warm_wave`` on frames: the deferred pool writes
        (every process, from the gathered previous wave), then this
        process's lanes gather their parents' frames, rewrite their RHS,
        run the dual simplex and the primal clean-up; the wave is
        gathered and summarised."""
        if opts is None:
            opts = SolverOptions.for_dtype(pool_T.dtype)
        ip = _ints(ipack, pool_T.device)
        pool_write(pool_T, pool_basis, ip[:, 2], prev_T, prev_basis,
                   ip[:, 3])
        ip = self.mine(ip)
        idx = ip[:, 0]
        T = self._rewrite(pool_T[idx], ip[:, 1], ip[:, 4].to(pool_T.dtype))
        st = _lanes(T, pool_basis[idx], col_active, art_cols)
        out = self.gather(self.dual_then_primal(
            st, opts, self._stall(opts, pool_T.shape[1] - 2), max_iters))
        return pool_T, pool_basis, out, _wave_summaries(out, R, const)

    @full_precision()
    def run_expand_generation(self, prev_T, prev_basis, summ_prev, active,
                              lbmat, ubmat, col_active, art_cols, le_col,
                              le_sign, ge_col, ge_sign, corner_cut, int_tol,
                              max_iters: int, R, const,
                              opts: SolverOptions | None = None):
        """``solve.dual.run_expand_generation`` over the gathered previous
        generation: the expansion plan for every lane (replicated), the
        children of this process's lanes built and re-optimized, the
        generation gathered and summarised."""
        if opts is None:
            opts = SolverOptions.for_dtype(prev_T.dtype)
        (pp, col, coef, status, parent_of, is_up, valid, lb_next, ub_next,
         e32) = expand_plan(summ_prev, active, lbmat, ubmat, le_col,
                            le_sign, ge_col, ge_sign, corner_cut, int_tol)
        pp, col, coef, status = (self.mine(x) for x in (pp, col, coef,
                                                         status))
        T = self._rewrite(prev_T[pp], col, coef)
        st = _lanes(T, prev_basis[pp], col_active, art_cols, status=status)
        out = self.gather(self.dual_then_primal(
            st, opts, self._stall(opts, prev_T.shape[1] - 2), max_iters))
        summary = genealogy_summary(out, R, const, parent_of, is_up)
        return out, summary, valid, lb_next, ub_next, e32

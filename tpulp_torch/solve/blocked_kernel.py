"""The kernel engine: blocks of ``blocked_inner_block`` + ``fused_flush``.

The counterpart of ``tpulp.solve.blocked_pallas``, with the same semantics
as the rank-K driver ``tpulp_torch.solve.blocked``. Each block runs up to K
pivots in one launch of the inner-block kernel, flushes ``T += U^T V`` in
place with the flush kernel, reduces the flush's scan columns to the
per-block ray test, and re-derives row0/row1/bvec from the flushed T. The
host reads ``iscal`` once per block; the budget is enforced there, so a run
may pass ``max_iters`` by up to K pivots, as tpulp's does.

What the TPU driver needed and this one drops: padding to 128 (a Mosaic
tile rule), the transposed copy Tt (Mosaic moved 8-row windows only), the
einsum flush for tableaus taller than the TPU's VMEM budget, and the f64
refusal (Hopper runs f64 natively, so both dtypes run the kernels).
"""

from __future__ import annotations

import torch

from ..core.precision import full_precision
from ..core.state import (SimplexState, SolverOptions, Status,
                          eta_scaled_options)
from ..kernels.block import blocked_inner_block, fused_flush
from .driver import finish

__all__ = ["kernel_block", "kernel_inputs", "run_simplex_blocked_kernel"]


def kernel_inputs(state: SimplexState):
    """The inner-block kernel's inputs for ``state``: ``(T, row0, row1,
    bvec, ca, ac, basis, ab, gamma, iscal, fscal)``, T a contiguous copy."""
    dev = state.T.device
    T = state.T.contiguous().clone()
    N = T.shape[1]
    i32 = dict(dtype=torch.int32, device=dev)
    ca = torch.zeros((N,), **i32)
    ca[:N - 1] = state.col_active.to(torch.int32)
    ac = torch.zeros((N,), **i32)
    ac[:N - 1] = state.art_cols.to(torch.int32)
    basis = state.basis.to(torch.int32).contiguous().clone()
    ab = state.art_cols[state.basis.long()].to(torch.int32)
    gamma = torch.ones((N,), dtype=T.dtype, device=dev)
    zero = torch.zeros((), **i32)
    iscal = torch.stack([state.phase.to(torch.int32),
                         state.status.to(torch.int32),
                         state.niter.to(torch.int32),
                         state.stuck.to(torch.int32),
                         state.bland.to(torch.int32), zero, zero, zero])
    fscal = torch.stack([state.last_z.to(T.dtype),
                         torch.zeros((), dtype=T.dtype, device=dev)])
    return (T, T[0].clone(), T[1].clone(), T[:, N - 1].clone(), ca, ac,
            basis, ab, gamma, iscal, fscal)


def kernel_block(inputs, opts: SolverOptions, stall_limit: int, K: int,
                 inner=blocked_inner_block, flush=fused_flush):
    """One block of the engine from ``inputs`` (as ``kernel_inputs``
    returns them): up to K pivots, the in-place flush of T, the ray test,
    and the running vectors re-derived from the flushed T. Returns the next
    block's inputs and the block's eta factors ``(U, V)``. ``inner`` and
    ``flush`` default to the kernels' wrappers; a check of the kernels
    passes their plain versions to run the same block on both."""
    T = inputs[0]
    (U, V, row0, row1, bvec, ca, ac, basis, ab, gamma, iscal,
     fscal) = inner(*inputs, opts, stall_limit, K)
    T, scan = flush(T, U, V, ca, float(opts.opt_tol), float(opts.piv_tol))
    # per-block ray test (as tpulp's kernel driver: no gate on basic
    # artificials, unlike the rank-K driver)
    ray = (((scan[0] > 0) & ~(scan[1] > 0)).any()
           & (iscal[0] == 2) & (iscal[1] == Status.RUNNING))
    iscal = iscal.clone()
    iscal[1] = torch.where(ray, Status.UNBOUNDED, iscal[1])
    iscal[5] = 0
    # re-derive the running vectors from the flushed tableau (kills
    # incremental drift once per block)
    N = T.shape[1]
    return ((T, T[0].clone(), T[1].clone(), T[:, N - 1].clone(), ca, ac,
             basis, ab, gamma, iscal, fscal), (U, V))


@full_precision()
def run_simplex_blocked_kernel(state: SimplexState,
                               opts: SolverOptions | None = None,
                               block: int = 128) -> SimplexState:
    """Run the kernel engine to termination or to ``opts.max_iters``
    (checked between blocks). On CPU tensors the kernels' plain versions
    run instead."""
    if opts is None:
        opts = SolverOptions.for_dtype(state.T.dtype)
    opts = eta_scaled_options(opts, state.T.dtype)
    stall_limit = opts.resolved_stall_limit(state.m, state.n)
    N = state.T.shape[1]

    inputs = kernel_inputs(state)
    host = inputs[9].tolist()
    while host[1] == Status.RUNNING and host[2] < opts.max_iters:
        inputs, _ = kernel_block(inputs, opts, stall_limit, block)
        host = inputs[9].tolist()

    T, _, _, _, ca, ac, basis, _, _, iscal, fscal = inputs
    return finish(SimplexState(
        T=T,
        basis=basis.clone(),
        col_active=ca[:N - 1] > 0,
        art_cols=ac[:N - 1] > 0,
        phase=iscal[0].clone(),
        status=iscal[1].clone(),
        niter=iscal[2].clone(),
        stuck=iscal[3].clone(),
        bland=iscal[4] > 0,
        last_z=fscal[0].clone(),
    ))

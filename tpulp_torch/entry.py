"""Entry points of the port: one simplex step, and a multi-device dry run.

The counterpart of ``__graft_entry__.py``. ``entry()`` returns ``(fn,
example_args)``: one ``simplex_step`` of the port on a small seeded
state, the solver's "forward step". ``dryrun_multichip(n)`` runs the
explicit column-sharded drivers over an n-process ``("cols",)`` mesh: one
rank-1 step and one blocked pivot with its flush, each held against the
solo driver, and the blocked driver's collective structure
(``shard.analysis.assert_fused_psum``). tpulp's dry run also steps a
batch over a 2-D ``(batch, cols)`` mesh and runs a MILP wave there; that
half waits for the batch slice of multi-device solving (ROADMAP queue A).

    python -m tpulp_torch.entry [N] [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import os
import socket
import sys

import numpy as np
import torch

__all__ = ["entry", "dryrun_multichip"]


def _tiny_state(dtype=torch.float32, m=8, n=12, seed=0, device="cuda"):
    """A seeded canonical LP with a slack basis: A ~ N(0, 1), b = A x0 +
    |N(0, 1)|, c ~ N(0, 1) (``__graft_entry__._tiny_state``'s recipe)."""
    from .core import make_state

    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n))
    x0 = np.abs(rng.normal(size=n))
    b = A @ x0 + np.abs(rng.normal(size=m))
    c = rng.normal(size=n)
    Afull = np.concatenate([A, np.eye(m)], axis=1)
    cfull = np.concatenate([c, np.zeros(m)])
    return make_state(cfull, Afull, b, list(range(n, n + m)), dtype=dtype,
                      device=device)


def entry(dtype=torch.float32, device="cuda"):
    """(fn, example_args): one port ``simplex_step`` (default options) on
    ``_tiny_state``."""
    from .core import SolverOptions
    from .solve.api import _device
    from .solve.driver import simplex_step

    opts = SolverOptions()
    state = _tiny_state(dtype=dtype, device=_device(device))
    stall = opts.resolved_stall_limit(state.m, state.n)

    def fn(s):
        return simplex_step(s, opts, stall)

    return fn, (state,)


def _dryrun_body(device: str) -> str:
    """The dry run on this process, inside an initialised group."""
    import dataclasses

    import torch.distributed as dist

    from .comm.collectives import MeshAxis
    from .core import SolverOptions
    from .shard import (from_sharded_state, make_mesh,
                        run_simplex_sharded_blocked, to_sharded_state)
    from .shard.analysis import assert_fused_psum
    from .shard.sharded import _sharded_step
    from .solve.blocked import run_simplex_blocked
    from .solve.driver import simplex_step

    n_dev = dist.get_world_size()
    mesh = make_mesh(n_dev, device=device)
    lay = MeshAxis(mesh)
    st = _tiny_state(m=6, n=10, seed=8, device=mesh.device_type)
    opts = SolverOptions.for_dtype(torch.float32)
    stall = opts.resolved_stall_limit(st.m, st.n)
    sh = to_sharded_state(st, mesh)

    # one rank-1 step: the gathered state is the solo step's, bit for bit
    one = from_sharded_state(
        _sharded_step(sh, opts, stall, sh.T.shape[1] * lay.size, lay), st.n,
        mesh)
    solo = simplex_step(st, opts, stall)
    if not (int(one.niter) == int(solo.niter) == 1
            and torch.equal(one.basis, solo.basis)
            and torch.equal(one.T, solo.T)):
        raise AssertionError("the sharded rank-1 step differs from the solo "
                             "step")
    # one blocked pivot and its flush
    opts1 = dataclasses.replace(opts, max_iters=1)
    blk = from_sharded_state(
        run_simplex_sharded_blocked(sh, mesh, opts1, block=8), st.n, mesh)
    ref = run_simplex_blocked(st, opts1, block=8)
    if not (int(blk.niter) == int(ref.niter) == 1
            and int(blk.status) == int(ref.status)
            and torch.equal(blk.basis, ref.basis)
            and torch.allclose(blk.T, ref.T, rtol=1e-6, atol=1e-6)):
        raise AssertionError("the sharded blocked step differs from the "
                             "solo blocked step")
    comm = assert_fused_psum(mesh, m=6, n=10, block=8)
    return (f"dryrun_multichip({n_dev}) on {mesh.device_type}: 1-D mesh "
            f"{tuple(mesh.mesh_dim_names)}; one rank-1 step bit for bit the "
            f"solo step's; one blocked pivot + flush equal to the solo "
            f"blocked driver's (status {int(blk.status)}); collectives a "
            f"pivot {comm['collectives_per_pivot']} (ONE fused "
            f"{comm['fused_psum_elems']}-element psum, "
            f"{comm['dependent_rounds_per_pivot']} dependent rounds), a "
            f"block {comm['collectives_per_block']}")


def _dryrun_rank(rank: int, n_devices: int, port: int, device: str) -> None:
    """One spawned process of ``dryrun_multichip``."""
    import torch.distributed as dist

    from .comm import init_distributed

    if device == "cpu":
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", n_devices, rank, device=device)
    try:
        line = _dryrun_body(device)
        if rank == 0:
            print(line, flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """Run the sharded drivers' dry run over ``n_devices`` processes: in
    this process when it already belongs to a group of that size (each
    process of the group calls it), else in ``n_devices`` processes it
    spawns on this host (gloo on ``cpu``, NCCL on ``cuda``, one card
    each). Raises when a check fails."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    kind = torch.device(device).type
    if dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"dryrun_multichip({n_devices}) in a group of "
                             f"{dist.get_world_size()} processes")
        line = _dryrun_body(kind)
        if dist.get_rank() == 0:
            print(line, flush=True)
        return
    if kind == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) needs "
                           f"{n_devices} cards; torch sees "
                           f"{torch.cuda.device_count()}")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.start_processes(_dryrun_rank, args=(n_devices, port, kind),
                       nprocs=n_devices, join=True, start_method="spawn")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("n", type=int, nargs="?", default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    fn, ex = entry(device=args.device)
    out = fn(*ex)
    print(f"entry: one simplex_step, niter {int(out.niter)}, status "
          f"{int(out.status)}", flush=True)
    dryrun_multichip(args.n, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where the sharded blocked pivot's time goes at P = 1 on the card.

Times, in turns in one process (ABBA), K = 64 pivots from the initial
basis of chip_smoke.py's 1536 x 1536 f64 LP (phase 5's; per-rank block
1538 x 3072):

* ``solo``: the solo rank-K pivot (``solve/blocked.py``);
* ``sharded``: the sharded pivot (``shard/sharded_blocked.py``) with its
  two collectives a pivot over a one-process NCCL group;
* ``stubbed``: the same sharded pivot with every collective replaced by
  its P = 1 value computed locally (a copy), so the difference to
  ``sharded`` is what the NCCL calls cost in context, and the difference
  of ``stubbed`` to ``solo`` the sharded bookkeeping.

Prints milliseconds a pivot for every turn (host clock, the block ended
by a synchronize). The host-bound engines drift 20-40% between and within
processes (PERF.md §5), so read the turns together.

    python tools/torch_shard_ab.py [--turns 4]
"""

from __future__ import annotations

import argparse
import os
import socket
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--block", type=int, default=64)
    args = ap.parse_args(argv)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)

    import torch
    import torch.distributed as dist

    import chip_smoke
    from tpulp_torch import SolverOptions
    from tpulp_torch.comm import init_distributed
    from tpulp_torch.comm.collectives import MeshAxis
    from tpulp_torch.core import eta_scaled_options
    from tpulp_torch.shard import make_mesh, to_sharded_state
    from tpulp_torch.shard.sharded_blocked import (_fresh_carry,
                                                   _sharded_blocked_pivot)
    from tpulp_torch.solve.api import state_from_standard_form
    from tpulp_torch.solve.blocked import _blocked_pivot
    from tpulp_torch.solve.blocked import _fresh_carry as solo_carry

    if not torch.cuda.is_available():
        print("torch_shard_ab: needs a CUDA card", file=sys.stderr)
        return 2
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    init_distributed(f"127.0.0.1:{port}", 1, 0, device="cuda")
    try:
        mesh = make_mesh(1, device="cuda")
        lay = MeshAxis(mesh)
        sf = chip_smoke.main_path_form(chip_smoke.MAIN_M, chip_smoke.MAIN_N)
        dt = torch.float64
        st = state_from_standard_form(sf, dtype=dt, device="cuda")
        opts = eta_scaled_options(SolverOptions.for_dtype(dt), dt)
        stall = opts.resolved_stall_limit(st.m, st.n)
        sh = to_sharded_state(st, mesh)
        K = args.block
        real = {n: getattr(MeshAxis, n)
                for n in ("psum", "pmin", "pmax", "all_gather")}
        local = {"psum": lambda self, x: x.clone(),
                 "pmin": lambda self, x: x.clone(),
                 "pmax": lambda self, x: x.clone(),
                 "all_gather": lambda self, x: x[None].clone()}

        def use(table):
            for name, fn in table.items():
                setattr(MeshAxis, name, fn)

        def sharded():
            c = _fresh_carry(sh._replace(T=sh.T.clone()), K, lay)
            for _ in range(K):
                c = _sharded_blocked_pivot(c, opts, stall, sh.T.shape[1],
                                           opts.max_iters, lay)
            torch.cuda.synchronize()

        def solo():
            c = solo_carry(st, K)
            for _ in range(K):
                c = _blocked_pivot(c, opts, stall, opts.max_iters)
            torch.cuda.synchronize()

        legs = [("solo", real, solo), ("sharded", real, sharded),
                ("stubbed", local, sharded)]
        for _, table, fn in legs:  # warm
            use(table)
            fn()
        times = {name: [] for name, _, _ in legs}
        for turn in range(args.turns):
            for name, table, fn in (legs if turn % 2 == 0 else legs[::-1]):
                use(table)
                t0 = time.perf_counter()
                fn()
                times[name].append(1e3 * (time.perf_counter() - t0) / K)
        use(real)
    finally:
        dist.destroy_process_group()
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(f"# torch_shard_ab on {smi}, {sf.m}x{sf.n} f64, K={K}, "
          f"{args.turns} turns ABBA", flush=True)
    for name, ts in times.items():
        print(f"{name}: ms a pivot " + " ".join(f"{t:.3f}" for t in ts)
              + f" (min {min(ts):.3f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

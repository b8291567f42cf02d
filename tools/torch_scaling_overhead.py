"""The sharded blocked driver's machinery cost per pivot, against the solo.

The port's counterpart of ``tools/scaling_overhead.py``: a fixed 66 x 513
float32 tableau (m = 64 rows, 448 structural + 64 slack columns, seed 7),
the rank-K eta drivers with K = 16 and a 200-pivot budget. It times the
sharded blocked driver on a one-process mesh (P = 1: every collective
still runs, over gloo on ``cpu`` or NCCL on ``cuda``) against the solo
``run_simplex_blocked`` on the same instance, best of ``--reps`` after a
warm run, and prints the per-pivot times and their ratio. P = 1 is the
configuration whose cost transfers (tpulp's SCALING.md §2): it measures
the partitioning machinery, the collectives and the per-shard
bookkeeping, not a cluster. The ratio cancels the machine's load, since
both legs slow alike.

    python tools/torch_scaling_overhead.py [--device cpu|cuda]
    python tools/torch_scaling_overhead.py --guard [--bound 4.0]

``--guard`` exits 1 when the ratio exceeds ``--bound``: a per-pivot
collective or host round trip added to the sharded path fails it.
"""

from __future__ import annotations

import argparse
import os
import socket
import sys
import time


def _ensure_path() -> None:
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)


def build_state(device: str):
    """The instance: 64 slack-basis rows, 512 columns, float32."""
    import numpy as np
    import torch

    from tpulp_torch.core import make_state

    m, n = 64, 448
    rng = np.random.default_rng(7)
    A = rng.normal(size=(m, n))
    x0 = np.abs(rng.normal(size=n))
    b = A @ x0 + np.abs(rng.normal(size=m))
    c = rng.normal(size=n)
    Afull = np.concatenate([A, np.eye(m)], axis=1)
    cfull = np.concatenate([c, np.zeros(m)])
    return make_state(cfull, Afull, b, list(range(n, n + m)),
                      dtype=torch.float32, device=device)


def _sync(device: str) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _time_best(run, pivots: int, reps: int, label: str, device: str):
    """(best us a pivot, pivots) of ``run()`` over ``reps`` timed runs."""
    out = run()  # warm
    niter = int(out.niter)
    assert niter >= pivots // 2, (
        f"{label}: the walk ended after {niter} pivots; the budget no "
        "longer measures steady-state machinery")
    best = float("inf")
    for _ in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        out = run()
        _ = int(out.niter)  # a host read: the run is complete
        best = min(best, time.perf_counter() - t0)
    return best / niter * 1e6, niter


def one_process_group(device: str) -> bool:
    """Bring up a one-process group on a free localhost port when none is
    up; returns whether this call made it."""
    import torch.distributed as dist

    from tpulp_torch.comm import init_distributed

    if dist.is_initialized():
        return False
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    init_distributed(f"127.0.0.1:{port}", 1, 0, device=device)
    return True


def measure(device: str, pivots: int = 200, reps: int = 5, block: int = 16):
    """{"solo_us", "p1_us", "ratio", "pivots"}: per-pivot times of the
    solo and the P = 1 sharded blocked driver on the instance."""
    import torch

    from tpulp_torch.core import SolverOptions
    from tpulp_torch.shard import (make_mesh, run_simplex_sharded_blocked,
                                   to_sharded_state)
    from tpulp_torch.solve.blocked import run_simplex_blocked

    st = build_state(device)
    opts = SolverOptions.for_dtype(torch.float32, max_iters=pivots)
    solo, niter = _time_best(
        lambda: run_simplex_blocked(st, opts, block=block), pivots, reps,
        "solo", device)
    mesh = make_mesh(1, device=device)
    sh = to_sharded_state(st, mesh)
    p1, niter1 = _time_best(
        lambda: run_simplex_sharded_blocked(sh, mesh, opts, block=block),
        pivots, reps, "P=1", device)
    assert niter1 == niter, (niter1, niter)
    return {"solo_us": solo, "p1_us": p1, "ratio": p1 / solo,
            "pivots": niter}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--guard", action="store_true",
                    help="exit 1 if the P=1 / solo ratio exceeds --bound")
    ap.add_argument("--bound", type=float, default=4.0)
    ap.add_argument("--pivots", type=int, default=200)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)

    _ensure_path()
    import torch
    import torch.distributed as dist

    if args.device == "cpu":
        torch.set_num_threads(1)
    made = one_process_group(args.device)
    try:
        res = measure(args.device, pivots=args.pivots, reps=args.reps)
    finally:
        if made:
            dist.destroy_process_group()
    ok = res["ratio"] <= args.bound
    print(f"{args.device}: solo {res['solo_us']:8.1f} us/pivot   P=1 "
          f"{res['p1_us']:8.1f} us/pivot   ratio {res['ratio']:.2f} "
          f"({res['pivots']} pivots)"
          + (f"  [guard bound {args.bound:.1f}: {'ok' if ok else 'FAIL'}]"
             if args.guard else ""), flush=True)
    return 0 if ok or not args.guard else 1


if __name__ == "__main__":
    sys.exit(main())

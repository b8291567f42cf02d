"""The mesh MILP beside the solo one on the card, in turns.

Solves chip_smoke.py's f64 bench knapsack (phase 7's and 10b's: 28
binaries, ``batch_size=128``, default chaining) in turns in one process,
over a one-process NCCL group:

* ``solo``: ``solve_milp`` without a mesh;
* ``batch``: on a 1-D ``("batch",)`` mesh (whole columns: the solo
  steps, one packed all_gather a wave);
* ``1x1``: on a ``(batch, cols)`` mesh of shape (1, 1) (the lane-sharded
  steps and their collectives).

The order turns around every turn (solo, batch, 1x1, then 1x1, batch,
solo, ...), after one untimed solve of each. Every run must give the DP
oracle's optimum and the solo run's ``BnbStats`` counters. Prints each
run's seconds, nodes/s and the ``BnbStats`` wave-time split, then with
``--profile`` the host functions that take most time in one more run of
each (cProfile, own time). The host-bound engines drift 20-40% between
and within processes (PERF.md §5), so read the turns together.

    python tools/torch_mesh_batch_ab.py [--turns 4] [--profile]
"""

from __future__ import annotations

import argparse
import cProfile
import io
import os
import pstats
import socket
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import chip_smoke
    import tpulp_torch
    from tpulp_torch.comm import init_distributed

    if not torch.cuda.is_available():
        print("torch_mesh_batch_ab: needs a CUDA card", file=sys.stderr)
        return 2
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    init_distributed(f"127.0.0.1:{port}", 1, 0, device="cuda")
    try:
        print(subprocess_smi(), flush=True)
        values, weights, cap = chip_smoke.bench_knapsack()
        oracle = chip_smoke.dp_knapsack(values, weights, cap)
        lp = chip_smoke.knapsack_lp(values, [weights], [cap])
        kw = {"dtype": torch.float64, "batch_size": chip_smoke.MILP_BATCH,
              "device": "cuda", "return_stats": True}
        sides = {
            "solo": {},
            "batch": {"mesh": init_device_mesh(
                "cuda", (1,), mesh_dim_names=("batch",)),
                "batch_axis": "batch"},
            "1x1": {"mesh": init_device_mesh(
                "cuda", (1, 1), mesh_dim_names=("batch", "cols"))},
        }
        want = None

        def run(side):
            nonlocal want
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sol, st = tpulp_torch.solve_milp(lp, **kw, **sides[side])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counters = chip_smoke.bnb_counters(st)
            want = counters if want is None else want
            if sol.objective != oracle or counters != want:
                raise AssertionError(f"{side}: {sol.objective} (oracle "
                                     f"{oracle}), {counters} != {want}")
            return secs, st

        for side in sides:
            run(side)
        order = list(sides)
        for turn in range(args.turns):
            for side in (order if turn % 2 == 0 else order[::-1]):
                secs, st = run(side)
                print(f"turn {turn} {side:5s} {secs:.3f} s = "
                      f"{st.nodes_solved / secs:.1f} nodes/s; assemble "
                      f"{st.t_assemble:.3f} s, device {st.t_device:.3f} s, "
                      f"process {st.t_process:.3f} s, verify "
                      f"{st.t_verify:.3f} s", flush=True)
        if args.profile:
            for side in order:
                prof = cProfile.Profile()
                prof.enable()
                run(side)
                prof.disable()
                out = io.StringIO()
                pstats.Stats(prof, stream=out).sort_stats(
                    "tottime").print_stats(12)
                print(f"--- profile {side} ---")
                print(out.getvalue().split("\n\n", 1)[-1].rstrip(),
                      flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def subprocess_smi() -> str:
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


if __name__ == "__main__":
    sys.exit(main())

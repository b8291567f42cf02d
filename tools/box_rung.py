"""The float32 box LP's precision-ladder rung: tpulp against tpulp_torch.

Solves chip_smoke.py's phase 8a box LP (``bounded_form``: bench.py's
recipe without its sum row, u_j = 2 x0_j + 1 on every structural, seed 0)
with ``simple_bounds`` at float32 through both packages on the CPU, and
prints each one's status, rung, steps and objective. On the card the port
answers the 1024 x 2048 form at float32 only after its float64 retry; this
script shows whether tpulp takes the same rung.

    python tools/box_rung.py [M ...] [--pricing devex|dantzig]

n = 2 M. It imports jax and tpulp (the comparison needs both), so it runs
here and not on the card's machine.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time


def _setup():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)


def rungs(m: int, pricing: str = "devex"):
    """{"tpulp": ..., "port": ...}: status, rung, niter and objective of
    the f32 solve of the M x 2M box LP in each package."""
    _setup()
    import jax.numpy as jnp
    import torch

    import chip_smoke
    import tpulp_torch
    from tpulp.model.lower import StandardForm
    from tpulp.solve import solve_lp

    sf = chip_smoke.bounded_form(m, 2 * m)[0]
    tsf = StandardForm(**{f.name: getattr(sf, f.name)
                          for f in dataclasses.fields(sf)})
    out = {}
    for name, solve in (
            ("tpulp", lambda: solve_lp(tsf, dtype=jnp.float32,
                                       pricing=pricing, max_iters=200_000)),
            ("port", lambda: tpulp_torch.solve_lp(
                sf, dtype=torch.float32, device="cpu", pricing=pricing,
                max_iters=200_000))):
        t0 = time.perf_counter()
        sol = solve()
        out[name] = {"status": sol.status, "rung": sol.rung,
                     "niter": sol.niter,
                     "objective": None if sol.objective is None
                     else float(sol.objective),
                     "seconds": time.perf_counter() - t0}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("m", type=int, nargs="*", default=[200, 400])
    ap.add_argument("--pricing", default="devex")
    args = ap.parse_args(argv)
    for m in args.m:
        res = rungs(m, args.pricing)
        for name, r in res.items():
            print(f"m={m} {args.pricing} float32 {name}: {r['status']}, rung "
                  f"{r['rung']}, {r['niter']} steps, objective "
                  f"{r['objective']!r} ({r['seconds']:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

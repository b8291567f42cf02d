#!/usr/bin/env python3
"""Phase 8 of chip_smoke.py (the bounded simplex and the exact layer) on
its own, on one CUDA card.

    python3 tools/torch_phase8.py [--pricing devex|dantzig]
                                  [--phases fma,lp,batch,blocked,exact]

Builds the kernels, then runs the chosen phases of ``chip_smoke.py`` with
the box LP priced by ``--pricing`` (chip_smoke's own choice by default),
printing their lines and, last, their numbers as one JSON object. Each
phase raises where chip_smoke's would; this script reports the failure
and goes on to the next phase, and exits non-zero if any failed. It
imports nothing of jax or tpulp.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PHASES = {"fma": "phase_fma", "lp": "phase_bounded_lp",
          "batch": "phase_bounded_batch", "blocked": "phase_blocked_batch",
          "exact": "phase_exact_layer"}


def main() -> int:
    import torch

    import chip_smoke as cs
    from tpulp_torch.kernels.build import build, load_library

    ap = argparse.ArgumentParser()
    ap.add_argument("--pricing", choices=["devex", "dantzig"],
                    default=cs.BND_PRICING)
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    cs.BND_PRICING = args.pricing
    t0 = time.perf_counter()
    cs.log(cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    with contextlib.redirect_stdout(io.StringIO()):
        build(verbose=True)
    load_library()
    cs.log(f"# build {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    out, failed = {"pricing": args.pricing}, []
    for key in args.phases.split(","):
        t = time.perf_counter()
        try:
            out[key] = getattr(cs, PHASES[key])(dev)
        except Exception:  # report it, run the other phases
            traceback.print_exc()
            failed.append(key)
        cs.log(f"## phase {key}: {time.perf_counter() - t:.1f} s")
    cs.log(f"# total {time.perf_counter() - t0:.1f} s; failed: {failed}")
    print(json.dumps(out, default=str))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

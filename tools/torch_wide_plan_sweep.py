#!/usr/bin/env python3
"""The wide plan of tpulp_torch's bounded grid walk, its ring swept on the
card.

    python3 tools/torch_wide_plan_sweep.py [SLOTS:TILE_BYTES ...]

On chip_smoke.py's 8a (z) (16 x 409,584 box LP, f64), (z64) and (z32)
(16 x 1,048,576, f64 and f32) frames, which take ``bounded_grid``'s wide
plan, one launch of 64 steps from a window where the walk pivots
(``chip_smoke.wide_window``) is timed on the card (CUDA events after a
sleep, median of three) for each variant of the ring: its slots
(``GRID_WIDE_SLOTS``) and the bytes a tile aims at
(``GRID_WIDE_TILE_BYTES``; TR the largest power of two of rows within
them), in turns (the variants, then the same in reverse), each launch's
state held equal to the first variant's. The plan's figures reach the
kernel as launch arguments, so the variants share one build. Default
variants: 6 and 8 slots of 16 KB, 4 and 6 of 32 KB, 3 of 64 KB. Prints
the card's name and power limit, then one JSON line. Needs one CUDA
card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

DEFAULT = [(6, 16_384), (8, 16_384), (4, 32_768), (6, 32_768), (3, 65_536)]
# (label, structural columns, dtype name): chip_smoke.py's (z) frames
FRAMES = (("z", 409_584, "float64"), ("z64", 1_048_576, "float64"),
          ("z32", 1_048_576, "float32"))
STEPS = 64


def main(argv: list[str]) -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from tpulp_torch.kernels import bounded_grid as kg
    from tpulp_torch.kernels.build import build, load_library

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    variants = [tuple(int(x) for x in a.split(":")) for a in argv] or DEFAULT
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    build()
    load_library()
    keep = (kg.GRID_WIDE_SLOTS, kg.GRID_WIDE_TILE_BYTES)
    out = {}
    try:
        for label, n, dt_name in FRAMES:
            dt = getattr(torch, dt_name)
            bs, opts = cs.past_state("cuda", cs.BND_WIDEST_M, dt, 4, n)
            stall = opts.resolved_stall_limit(bs.s.m, bs.s.n)
            start, _ = cs.wide_window(bs, opts, "cuda", dt,
                                      cs.BND_WIDEST_STEPS)
            mid = kg.bounded_grid(bs, opts, stall, start)
            first, turns = None, {}
            for slots, tile in variants + variants[::-1]:
                kg.GRID_WIDE_SLOTS, kg.GRID_WIDE_TILE_BYTES = slots, tile
                kg.bounded_grid_plan.cache_clear()
                plan = kg.bounded_grid_plan(*bs.s.T.shape, dt, kg.GRID_SMS)
                k = kg.bounded_grid(mid, opts, stall, start + STEPS)
                if first is None:
                    first = k
                cs.bounded_equal(k, first)
                runs = [cs.launches_us(lambda: kg.bounded_grid(
                    mid, opts, stall, start + STEPS), STEPS)[0]
                    for _ in range(3)]
                turns.setdefault(
                    f"{slots} slots of {tile} bytes (TR {plan.tile_rows})",
                    []).append(float(np.median(runs)))
            out[label] = {"window_from": start, "steps": STEPS,
                          "device_us_per_step": turns}
    finally:
        kg.GRID_WIDE_SLOTS, kg.GRID_WIDE_TILE_BYTES = keep
        kg.bounded_grid_plan.cache_clear()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""shard_pivot's launch plan swept on the card.

    python3 tools/torch_shard_pivot_sweep.py

On seeded blocks of the sharded paths' shapes (9b's 1538 x 3072 block and
its RHS at f64 and f32, 10a's 64 lanes of 66 x 193 frames, 10b's 128 lanes
of 59 x 114), times one ``shard_pivot`` launch on the card (CUDA events
after a sleep, the median of 30) for each plan of a grid of the plan's
knobs (the CTAs a launch aims at, the threads a CTA, the rows in flight a
thread: the chunk's least rows), each checked equal to the default
plan's output. Needs a CUDA
card; prints the card's name and power limit last."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import tpulp_torch.kernels.shard_pivot as sp  # noqa: E402
from tpulp_torch.kernels.build import build, load_library  # noqa: E402

build()
load_library()
rng = np.random.default_rng(0)


def case(L, R, N, dt, frame):
    fr = torch.tensor(rng.normal(size=(L, R, N + 1)), dtype=dt,
                      device="cuda")
    if frame:
        T, b = fr[..., :-1], fr[..., -1]
    else:
        T, b = fr[..., :-1].contiguous(), fr[..., -1].contiguous()
    u = torch.tensor(rng.normal(size=(L, R)), dtype=dt, device="cuda")
    rg = torch.full((L,), 5, dtype=torch.int64, device="cuda")
    j = torch.full((L,), N + 3, dtype=torch.int64, device="cuda")
    return (T, b, u, rg, j, 1, None, None, frame)


cases = {"9b f64": case(1, 1538, 3072, torch.float64, False),
         "9b f32": case(1, 1538, 3072, torch.float32, False),
         "10a": case(64, 66, 192, torch.float64, True),
         "10b": case(128, 59, 113, torch.float64, True)}
base = (sp._CTAS, sp.PIVOT_THREADS, sp._ROWS_IN_FLIGHT)
for name, args in cases.items():
    ref = sp._launch(*args)
    for ctas in (264, 528, 1024, 2048, 4096, 8192):
        for threads in (128, 256):
            for rows_in_flight in (4, 8):
                sp._CTAS, sp.PIVOT_THREADS, sp._ROWS_IN_FLIGHT = \
                    ctas, threads, rows_in_flight
                out = sp._launch(*args)
                same = all(torch.equal(a, b) for a, b in zip(
                    out if isinstance(out, tuple) else (out,),
                    ref if isinstance(ref, tuple) else (ref,)))
                L, R, N = args[0].shape
                vec = 16 // args[0].element_size() if name.startswith("9b") \
                    else 1
                plan = sp.shard_pivot_plan(L, R, N, vec)
                ms = cs.device_time_ms(lambda: sp._launch(*args), 30)
                print(f"{name} ctas {ctas} threads {threads} rows in flight "
                      f"{rows_in_flight}: {plan} {ms:.4f} ms "
                      f"{'same' if same else 'DIFFERS'}", flush=True)
    sp._CTAS, sp.PIVOT_THREADS, sp._ROWS_IN_FLIGHT = base
print(os.popen("nvidia-smi --query-gpu=name,power.limit "
               "--format=csv,noheader").read())

#!/usr/bin/env python3
"""Host-bound engines of tpulp_torch on the card, compared between trees.

    python3 tools/torch_engine_ab.py TREE[:MODE] [TREE[:MODE] ...]

Each TREE is the root of a checkout of this repository (``.`` for this
one); give two in turns (parent, change, change, parent) to compare them
within one machine. MODE ``addcmul`` runs that tree with CUDA's
``torch.addcmul`` patched in for ``fused_fma`` in the engines (for a tree
that has the FMA op), and ``interleave`` runs the tree as built (A) and
with ``addcmul`` (B) in one process, ABBA ABBA, which isolates the op's
cost from the spread between processes and the drift within one;
``profile`` runs 640 pivots of the blocked engine (512 x 512, f32) as
built and with ``addcmul`` (ABBA) under ``torch.profiler``: ms a pivot,
the ops' CPU and device time a pivot, and the top ops by CPU time. For each tree, in a fresh
process: the rank-K blocked engine on bench.py's instance at 512 x 512
(f32) and the rank-1 engine at 256 x 256 (f64), each solved once to warm
up and then timed: the whole ``solve_lp`` and the engine alone (host
clock, synchronised; ms per pivot), and the host time of one rank-1
``pivot_update`` on that 258 x 513 tableau. Then, for this tree
only, the host time of one call of ``fused_fma`` (the engines' direct
launch), of ``fma_op`` (the custom op a vmapped step goes through) and of
``torch.addcmul``, on a 3073-element running-vector update, and whether
loading the kernels' library (which carries its own CUDA runtime) slows
the torch launches around it: ``pivot_update`` with ``addcmul``, six
rounds, with the library loaded before round 4 and in a control process
never. Needs one CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

SOLVE = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
import tpulp_torch
import tpulp_torch.solve.api as api
from tpulp_torch.solve import blocked, driver

AS_BUILT = {m: getattr(m, "fused_fma", None) for m in (driver, blocked)}

def use(fma):
    for m, fn in AS_BUILT.items():
        if fma == "addcmul":
            m.fused_fma = (lambda c, a, b, value=1.0:
                           torch.addcmul(c, a, b, value=value))
        elif fn is not None:
            m.fused_fma = fn

engine = {"seconds": 0.0}

def timed(fn):
    def run(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        engine["seconds"] += time.perf_counter() - t0
        return out
    return run

for name in ("run_simplex", "run_simplex_devex", "run_simplex_blocked"):
    setattr(api, name, timed(getattr(api, name)))
CASES = (("blocked f32 512x512", 512,
          dict(dtype=torch.float32, driver="blocked")),
         ("rank1 f64 256x256", 256, dict(dtype=torch.float64,
                                           driver="rank1")))
FORMS = {n: cs.standard_form(*cs.bench_arrays(n, n), n)
         for _, n, _ in CASES}

def solve(name, n, kw):
    engine["seconds"] = 0.0
    t0 = time.perf_counter()
    sol = tpulp_torch.solve_lp(FORMS[n], device="cuda", **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    piv = max(sol.niter, 1)
    return {"status": sol.status, "niter": sol.niter, "seconds": secs,
            "ms_per_pivot": 1e3 * secs / piv,
            "engine_seconds": engine["seconds"],
            "engine_ms_per_pivot": 1e3 * engine["seconds"] / piv}

def pivot_update_us():
    T = torch.randn(258, 513, dtype=torch.float64, device="cuda")
    r, j = (torch.tensor(k, device="cuda") for k in (7, 11))
    for _ in range(50):
        driver.pivot_update(T, r, j)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1000):
        driver.pivot_update(T, r, j)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)

mode = sys.argv[2]
# "interleave": as built (A) and with addcmul (B) in this process, in the
# order ABBA ABBA, so that a drift within the process cancels
modes = (["as-built", "addcmul", "addcmul", "as-built"] * 2
         if mode == "interleave" else [mode])
for name, n, kw in CASES:  # warm-up
    use(modes[0])
    tpulp_torch.solve_lp(FORMS[n], device="cuda", **kw)
runs = []
for fma in modes:
    use(fma)
    out = {name: solve(name, n, kw) for name, n, kw in CASES}
    out["pivot_update_us"] = pivot_update_us()
    runs.append({"fma": fma, "engines": out})
print(json.dumps({"tree": tpulp_torch.__file__, "runs": runs}))
"""


PROFILE = r"""
import dataclasses, json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
import tpulp_torch
import tpulp_torch.solve.api as api
from tpulp_torch.solve import blocked

PIVOTS = 640
captured = {}
run = api.run_simplex_blocked

def capture(state, opts, block=64):
    captured.setdefault("args", (state, opts, block))
    return run(state, opts, block=block)

api.run_simplex_blocked = capture
form = cs.standard_form(*cs.bench_arrays(512, 512), 512)
tpulp_torch.solve_lp(form, device="cuda", dtype=torch.float32,
                     driver="blocked")
state, opts, block = captured["args"]
opts = dataclasses.replace(opts, max_iters=PIVOTS)
as_built = blocked.fused_fma
out = []
for fma in ("as-built", "addcmul", "addcmul", "as-built"):
    blocked.fused_fma = as_built if fma == "as-built" else (
        lambda c, a, b, value=1.0: torch.addcmul(c, a, b, value=value))
    run(state, opts, block=block)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(state, opts, block=block)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(state, opts, block=block)
        torch.cuda.synchronize()
    ev = prof.key_averages()
    top = sorted(ev, key=lambda e: -e.self_cpu_time_total)[:12]
    out.append({
        "fma": fma, "ms_per_pivot": 1e3 * wall / PIVOTS,
        "op_cpu_us_per_pivot": sum(e.self_cpu_time_total
                                   for e in ev) / PIVOTS,
        "device_us_per_pivot": sum(e.self_device_time_total
                                   for e in ev) / PIVOTS,
        "top_cpu_us_per_pivot": {e.key: e.self_cpu_time_total / PIVOTS
                                 for e in top}})
print(json.dumps({"tree": tpulp_torch.__file__, "profile": out}))
"""


LIBRARY = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from tpulp_torch.kernels import fused_fma
from tpulp_torch.solve import driver

driver.fused_fma = (lambda c, a, b, value=1.0:
                    torch.addcmul(c, a, b, value=value))
T = torch.randn(258, 513, dtype=torch.float64, device="cuda")
r, j = (torch.tensor(k, device="cuda") for k in (7, 11))

def pivot_update_us(calls=2000):
    for _ in range(50):
        driver.pivot_update(T, r, j)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        driver.pivot_update(T, r, j)
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / calls

out = []
for k in range(6):
    if k == 3 and sys.argv[2] == "load":
        x = torch.ones(8, dtype=torch.float64, device="cuda")
        fused_fma(x, x, x)  # loads the kernels' library and launches
        torch.cuda.synchronize()
    out.append(pivot_update_us())
print(json.dumps({sys.argv[2]: out}))
"""


def library_effect(root: str) -> dict:
    """Host us of one rank-1 ``pivot_update`` with CUDA's ``addcmul`` (no
    call of the kernels' library), six rounds in a fresh process: in one
    process the library is loaded and launched once before round 4, in
    the other never (the control)."""
    res = {}
    for mode in ("control", "load"):
        run = subprocess.run([sys.executable, "-c", LIBRARY, root, mode],
                             cwd=root, capture_output=True, text=True)
        if run.returncode != 0:
            raise RuntimeError(run.stdout + run.stderr)
        res.update(json.loads(run.stdout.strip().splitlines()[-1]))
    return res


def fma_host_us(calls: int = 2000) -> dict:
    """Host microseconds per call: fused_fma, fma_op and torch.addcmul."""
    import torch

    from tpulp_torch.kernels import fused_fma
    from tpulp_torch.kernels.fma import fma_op

    dev = torch.device("cuda")
    c, b = (torch.randn(3073, device=dev, dtype=torch.float64)
            for _ in range(2))
    a = torch.randn((), device=dev, dtype=torch.float64)
    res = {}
    for name, fn in (("fused_fma", lambda: fused_fma(c, a, b)),
                     ("fma_op", lambda: fma_op(c, a, b)),
                     ("addcmul", lambda: torch.addcmul(c, a, b))):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        res[name] = 1e6 * (time.perf_counter() - t0) / calls
        torch.cuda.synchronize()
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_engine_ab: needs a CUDA card", file=sys.stderr)
        return 2
    for spec in sys.argv[1:] or ["."]:
        tree, _, fma = spec.partition(":")
        root = os.path.abspath(tree)
        script = PROFILE if fma == "profile" else SOLVE
        res = subprocess.run([sys.executable, "-c", script, root,
                              fma or "as-built"], cwd=root,
                             capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode
        print(res.stdout.strip().splitlines()[-1], flush=True)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, here)
    print(json.dumps({"fma_host_us": fma_host_us()}))
    print(json.dumps({"pivot_update_us_addcmul": library_effect(here)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

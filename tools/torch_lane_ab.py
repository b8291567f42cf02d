#!/usr/bin/env python3
"""The dual lane loop of tpulp_torch on the card, compared between trees.

    python3 tools/torch_lane_ab.py TREE [TREE ...]

Each TREE is the root of a checkout of this repository (``.`` for this
one); give two in turns (parent, change, change, parent) to compare them
within one machine. For each, in a fresh process that builds the tree's
own kernels, timed on the card alone (``chip_smoke.device_time_ms``: CUDA
events after a sleep, the median of 15 calls), in device us a step (the
longest lane's pivots):

- the bench knapsack's warm wave (chip_smoke.py 7d's ``knapsack_warm``:
  128 lanes of 59 x 114, f64 and f32) on ``lane_dual``, with its stage
  split on block 0's clock (block 0 given the lane with the most pivots;
  its steps, its pivots and the step that ends it) and its block barriers
  a step where the tree's ``lane_dual`` takes ``stage_cycles``;
- 7d's ``streamed_warm`` (8 lanes of 258 x 513, f64) on ``dual_lanes``'
  route and on ``lane_dual``'s one block a lane in device memory, and 128
  such lanes (7d (w)'s frames, each with one row tightened) on both;
- 5c (e)'s resident warm re-solve (42 x 121, f64 and f32) on ``lane_dual``
  at B = 1;
- the host's time of one ``lane_dual`` call on the knapsack's warm wave at
  a budget of 0 (the least and the median over 7 batches of 500 calls),
  whole and by part (the operands' checks and the plan, the allocations,
  the argument arrays and the rest, the C call that launches), each part
  timed by wrapping the module's functions.

Prints one JSON line a tree, with ptxas's registers and spills of the lane
kernels. Needs one CUDA card.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

RUN = r"""
import collections, contextlib, dataclasses as dc, inspect, io, json, sys
import time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import chip_smoke as cs
from tpulp_torch.kernels.build import build, load_library

report = io.StringIO()
with contextlib.redirect_stdout(report):
    build(verbose=True)
lib = load_library()
import tpulp_torch
from tpulp_torch import SolverOptions
from tpulp_torch.batch import make_batched_states
from tpulp_torch.kernels import lanes as kl
from tpulp_torch.solve import lanes
from tpulp_torch.solve.api import state_from_standard_form
from tpulp_torch.solve.dual import warm_state_from_basis

NEW = "stage_cycles" in inspect.signature(kl.lane_dual).parameters
ROUTED = "route" in inspect.signature(lanes.dual_lanes).parameters
RUNS = 15
out = {"tree": sys.argv[2], "card": torch.cuda.get_device_name(0),
       "ptxas": {k: v for k, v in cs.ptxas_report(report.getvalue()).items()
                 if k.startswith("lane_")}}


def timed(label, fn, st):
    res = fn()
    torch.cuda.synchronize()
    steps = max(1, int((res.niter - st.niter).max()))
    ms = cs.device_time_ms(fn, RUNS)
    out[label] = {"device_ms": ms, "steps": steps,
                  "us_per_step": 1e3 * ms / steps}
    print(label, out[label], flush=True)
    return res


def stages(label, st, opts, stall, res):
    if not NEW:
        return
    # block 0's clock on the lane with the most pivots, moved to the front
    dn = res.niter - st.niter
    first = int(torch.argmax(dn))
    order = torch.tensor([first] + [b for b in range(st.T.shape[0])
                                    if b != first], device="cuda")
    st = type(st)(*(x.index_select(0, order) for x in st))
    cyc = torch.zeros(len(kl.LANE_STAGES), dtype=torch.int64, device="cuda")
    kl.lane_dual(st, opts, stall, opts.max_iters, stage_cycles=cyc)
    torch.cuda.synchronize()
    # its steps: its pivots and, where it ended below its budget, the step
    # that ended it
    steps0 = max(1, int(dn[first]) + int(int(res.status[first]) != 0))
    hz = cs.sm_clock_hz()
    vals = dict(zip(kl.LANE_STAGES, cyc.tolist()))
    out[label]["lane0_steps"] = steps0
    out[label]["barriers_per_step"] = vals.pop("barriers") / steps0
    out[label]["stage_us_per_step"] = {k: 1e6 * v / hz / steps0
                                       for k, v in vals.items()}


def dual(st, opts, stall, route=None):
    if route is None or not ROUTED:
        return lanes.dual_lanes(st, opts, stall, opts.max_iters)
    return lanes.dual_lanes(st, opts, stall, opts.max_iters, route=route)


def tightened(solved, rng, B):
    rows = rng.integers(0, cs.LANE_STREAM_M, size=B)
    scale = torch.tensor(rng.uniform(0.5, 1.5, size=B),
                         dtype=solved.T.dtype, device="cuda")
    return cs.rewritten(
        solved, torch.as_tensor(cs.LANE_STREAM_N + rows, device="cuda"),
        -scale * solved.T[:, 2:, -1].abs().amax(dim=1))


def batches(call, n=500, k=7):
    # us a call over k batches of n calls: (the least, the median)
    means = []
    for _ in range(k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        means.append(1e6 * (time.perf_counter() - t0) / n)
    torch.cuda.synchronize()
    return min(means), float(np.median(means))


def host_parts(warm, opts, stall):
    # the host's time of one lane_dual call at a budget of 0, whole, then
    # by part with the module's functions wrapped (each part's share taken
    # from the batch of the least time)
    o0 = dc.replace(opts, max_iters=0)
    call = lambda: kl.lane_dual(warm, o0, stall, 0)
    for _ in range(200):
        call()
    whole = batches(call)
    acc = collections.defaultdict(float)

    def wrap(part, fn):
        def w(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                acc[part] += time.perf_counter() - t
        return w

    saved = {}
    for name in ("_call", "_vector", "_scalar", "lane_dual_plan"):
        if hasattr(kl, name):
            saved[name] = getattr(kl, name)
            setattr(kl, name, wrap("checks and plan", saved[name]))
    empty = torch.empty
    torch.empty = wrap("allocations", empty)
    entry = "tpulp_lane_dual_f64"
    raw = getattr(lib, entry)
    setattr(lib, entry, wrap("call", raw))
    best = None
    try:
        for _ in range(200):
            call()
        for _ in range(7):
            acc.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(500):
                call()
            total = 1e6 * (time.perf_counter() - t0) / 500
            if best is None or total < best[0]:
                best = (total, {k: 1e6 * v / 500 for k, v in acc.items()})
    finally:
        torch.empty = empty
        setattr(lib, entry, raw)
        for name, fn in saved.items():
            setattr(kl, name, fn)
    torch.cuda.synchronize()
    wrapped, parts = best
    parts["argument arrays and the rest"] = wrapped - sum(parts.values())
    return {"us_per_call_least": whole[0], "us_per_call_median": whole[1],
            "wrapped_us_per_call": wrapped, "parts_us": parts}


for dt in (torch.float64, torch.float32):
    name = str(dt)[6:]
    rng = np.random.default_rng(cs.LANE_SEED)
    opts = SolverOptions.for_dtype(dt)
    cold, sf, _, streamed, _ = cs.lane_inputs(dt)
    B, M, N = cold.T.shape
    stall = opts.resolved_stall_limit(M - 2, N - 1)
    solved = lanes.primal_lanes(cold, opts, stall, opts.max_iters)
    slack = [j for j, nm in enumerate(sf.col_names)
             if j >= sf.n_struct and nm[:2] in ("_s", "_e")]
    cols = torch.tensor(rng.choice(slack, size=cs.MILP_BATCH), device="cuda")
    coef = torch.tensor(rng.uniform(-1.5, -0.25, size=cs.MILP_BATCH),
                        dtype=dt, device="cuda")
    warm = cs.rewritten(solved, cols, coef)
    label = f"knapsack_warm {name}"
    res = timed(label, lambda: kl.lane_dual(warm, opts, stall,
                                            opts.max_iters), warm)
    stages(label, warm, opts, stall, res)
    if dt == torch.float64:
        out[f"host {name}"] = host_parts(warm, opts, stall)
        print("host", out[f"host {name}"], flush=True)
        st2 = opts.resolved_stall_limit(cs.LANE_STREAM_M,
                                        cs.LANE_STREAM_M + cs.LANE_STREAM_N)
        s_solved = lanes.primal_lanes(streamed, opts, st2, opts.max_iters)
        warm_s = tightened(s_solved, rng, cs.LANE_STREAM_LANES)
        wide = make_batched_states(
            [cs.scenario_form(*cs.dense_leq_arrays(
                cs.LANE_STREAM_M, cs.LANE_STREAM_N, seed=k))
             for k in range(cs.LANE_WIDE_LANES)], dtype=dt, device="cuda")
        w_solved = lanes.primal_lanes(wide, opts, st2, opts.max_iters)
        warm_w = tightened(w_solved, np.random.default_rng(cs.LANE_SEED),
                           cs.LANE_WIDE_LANES)
        for lab, st in (("streamed_warm", warm_s), ("wide_128_dual", warm_w)):
            turns = {"route": [], "one_block": []}
            for route in ("route", "one_block", "one_block", "route"):
                if route == "route":
                    fn = lambda: dual(st, opts, st2)
                elif NEW:
                    fn = lambda: kl.lane_dual(st, opts, st2, opts.max_iters,
                                              resident=False)
                else:
                    fn = lambda: kl.lane_dual(st, opts, st2, opts.max_iters)
                timed(f"{lab} {route} {name}", fn, st)
                turns[route].append(out.pop(f"{lab} {route} {name}"))
            for route, runs in turns.items():
                out[f"{lab} {route} {name}"] = {
                    "steps": runs[0]["steps"],
                    "device_ms": [r["device_ms"] for r in runs],
                    "us_per_step": [r["us_per_step"] for r in runs]}
    # 5c (e): the resident warm re-solve at B = 1
    ci, Ai, bi, hi = cs.main_path_arrays(cs.SOLO_RESIDENT_M,
                                         cs.SOLO_RESIDENT_N, seed=3)
    sf_ci = cs.standard_form(ci, Ai, bi, hi, cs.SOLO_RESIDENT_N)
    # chip_smoke.py 5c's cut: the first 1 / SOLO_CUT of the rows halved
    b2, k = bi.copy(), len(bi) // cs.SOLO_CUT
    b2[:k] = b2[:k] // 2
    sf_ci2 = cs.standard_form(ci, Ai, b2, hi, cs.SOLO_RESIDENT_N)
    solc = tpulp_torch.solve_lp(sf_ci, dtype=dt, device="cuda")
    s2 = state_from_standard_form(sf_ci2, dtype=dt, device="cuda")
    frame = warm_state_from_basis(
        s2.T[2:, :-1], s2.T[0, :-1], s2.col_active & ~s2.art_cols,
        s2.art_cols, np.asarray(solc.basis, np.int32), s2.T[2:, -1])
    st1 = opts.resolved_stall_limit(frame.m, frame.n)
    one = type(frame)(*(x.contiguous().unsqueeze(0) for x in frame))
    timed(f"resident_resolve_b1 {name}",
          lambda: kl.lane_dual(one, opts, st1, opts.max_iters), one)
print("RESULT " + json.dumps(out))
"""


def main(trees: list[str]) -> int:
    if not trees:
        raise SystemExit(__doc__)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for tree in trees:
        root = Path(tree).resolve()
        res = subprocess.run([sys.executable, "-c", RUN, str(root), tree],
                             cwd=root, capture_output=True, text=True)
        lines = [ln for ln in res.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if res.returncode or not lines:
            print(res.stdout[-2000:] + res.stderr[-4000:], file=sys.stderr)
            return res.returncode or 1
        print(lines[-1][len("RESULT "):], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

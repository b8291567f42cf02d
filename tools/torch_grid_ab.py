#!/usr/bin/env python3
"""The bounded grid walk of tpulp_torch on the card, compared between trees.

    python3 tools/torch_grid_ab.py TREE[:fixed_order] [TREE[:MODE] ...]

Each TREE is the root of a checkout of this repository (``.`` for this
one); give two in turns (parent, change, change, parent) to compare them
within one machine. For each, in a fresh process that builds the tree's
own kernels: one ``bounded_grid`` launch of 1,024 steps from step 2,000
timed on the card (``chip_smoke.bounded_grid_us``: CUDA events after a
sleep, median of three, by stage) on 8a's resident frame (1026 x 3073,
f64, devex and Dantzig) and, where the tree has the streamed plan, on
(w)'s streamed frame (2050 x 4097, devex, f64 and f32); with ptxas's
registers and spills of the grid's instantiations. MODE ``fixed_order``
runs a copy of the tree (under its ``build/``) whose streamed update
walks the tiles in the same order every step, where the kernel reverses
it every other step. Prints one JSON line a run. Needs one CUDA card.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

RUN = r"""
import contextlib, io, json, re, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
from tpulp_torch.kernels.build import build, load_library

report = io.StringIO()
with contextlib.redirect_stdout(report):
    build(verbose=True)
load_library()
ptxas, fn = {}, None
for line in report.getvalue().splitlines():
    m = re.search(r"Function properties for (\w+)", line)
    if m:
        fn = m.group(1)
    elif fn and "grid_kernel" in fn:
        for key, pat in (("spill_bytes", r"(\d+) bytes spill stores, (\d+)"),
                         ("registers", r"Used (\d+) registers")):
            m = re.search(pat, line)
            if m:
                ptxas.setdefault(fn, {})[key] = sum(map(int, m.groups()))
out = {"tree": sys.argv[2], "ptxas": ptxas}
sf = cs.bounded_form(cs.BND_M, cs.BND_N)[0]
for devex in (True, False):
    g = cs.bounded_grid_us(sf, "cuda", torch.float64, devex)
    out["8a " + ("devex" if devex else "dantzig")] = g["device_us_per_step"]
src = open("tpulp_torch/kernels/csrc/bounded_grid.cu").read()
if "STREAMED" in src:
    sw = cs.bounded_form(cs.BND_WIDE_M, cs.BND_WIDE_N, seed=1)[0]
    for dt in (torch.float64, torch.float32):
        g = cs.bounded_grid_us(sw, "cuda", dt, True)
        name = "w " + str(dt).replace("torch.", "")
        out[name] = g["device_us_per_step"]
        out[name + " by stage"] = g["device_us_by_stage"]
print("RESULT " + json.dumps(out))
"""

# the kernel's line that reverses the tiles' order every other step
REVERSE = "      forward = !forward;\n"


def tree_for(spec: str) -> tuple[Path, str]:
    """(the tree to run, its label): TREE, or a copy of it with the tiles'
    order fixed."""
    root, _, mode = spec.partition(":")
    root = Path(root).resolve()
    if not mode:
        return root, spec
    if mode != "fixed_order":
        raise SystemExit(f"unknown mode {mode!r}")
    copy = root / "build" / "grid_ab_fixed_order"
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(root, copy, ignore=shutil.ignore_patterns(
        "build", ".git", "__pycache__"))
    cu = copy / "tpulp_torch" / "kernels" / "csrc" / "bounded_grid.cu"
    src = cu.read_text()
    if src.count(REVERSE) != 1:
        raise SystemExit(f"{cu}: no line {REVERSE.strip()!r} to take out")
    cu.write_text(src.replace(REVERSE, ""))
    return copy, spec


def main(specs: list[str]) -> int:
    if not specs:
        raise SystemExit(__doc__)
    for spec in specs:
        root, label = tree_for(spec)
        res = subprocess.run([sys.executable, "-c", RUN, str(root), label],
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

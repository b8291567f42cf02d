"""The communication structure of the sharded drivers, from counted calls.

The counterpart of ``tpulp.shard.analysis``, which counts the collective
instructions in the drivers' compiled StableHLO. Here the collectives are
calls, each counted by ``comm.collectives.COUNTS`` as it is made, so
``collective_profile`` walks a driver for a fixed number of steps and
reads the counts: what the drivers really issue per pivot and per block,
not what a docstring claims.

``assert_fused_psum`` holds the blocked driver to its structure: per pivot
ONE all_gather of the packed pricing candidates and ONE fused psum of the
m+2 column lanes, the K eta lanes and the artificial-flag lane (plus the
weight lane and one scalar pmax under devex), so two dependent collective
rounds; per block one (m,) int32 ``art_basic`` seed and one 2-lane int32
(ray, non-finite) psum; nothing else. The rank-1 driver's step (profiled
with ``driver='rank1'``) makes the same packed gather, the (m,) int32
cleanup scan, one (m+2) column psum and one scalar guard psum.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict

import numpy as np
import torch

from ..comm.collectives import COUNTS, MeshAxis, reset_counts
from ..core.state import (RULE_DEVEX, SolverOptions, eta_scaled_options,
                          make_state)

__all__ = ["collective_profile", "assert_fused_psum"]

_BYTES = {"float32": 4, "float64": 8, "int32": 4, "int64": 8, "bool": 1,
          "uint8": 1}


def _instance(m: int, n: int, dtype, device):
    """tpulp's profile instance: A ~ N(0, 1), b = |A |x0|| + 0.5, c ~
    N(0, 1), slack basis (seed 0)."""
    rng = np.random.default_rng(0)
    A = rng.normal(size=(m, n))
    b = np.abs(A @ np.abs(rng.normal(size=n))) + 0.5
    c = rng.normal(size=n)
    return make_state(np.concatenate([c, np.zeros(m)]),
                      np.concatenate([A, np.eye(m)], axis=1), b,
                      list(range(n, n + m)), dtype=dtype, device=device)


def collective_profile(mesh, m=6, n=10, block=8, driver="blocked",
                       dtype=torch.float32, rule=None,
                       steps=8) -> Dict[str, object]:
    """Walk a sharded driver on the (m, n) instance over ``mesh`` and
    count its collectives: ``driver='blocked'`` for one block (``block``
    pivot steps, its flush and the next block's seed), ``'rank1'`` for
    ``steps`` steps. Returns ``{"steps", "blocks", "calls"}``
    with ``calls`` a Counter over ``(kind, dtype, elements)``."""
    from .sharded import _sharded_step, to_sharded_state
    from .sharded_blocked import (_flush, _fresh_carry,
                                  _sharded_blocked_pivot)

    st = _instance(m, n, dtype, mesh.device_type)
    opts = SolverOptions.for_dtype(dtype)
    if rule is not None:
        opts = dataclasses.replace(opts, rule=rule)
    lay = MeshAxis(mesh)
    sh = to_sharded_state(st, mesh)
    n_global = sh.T.shape[1] * lay.size
    stall = opts.resolved_stall_limit(m, n_global)
    reset_counts()
    if driver == "blocked":
        opts = eta_scaled_options(opts, dtype)
        carry = _fresh_carry(sh, block, lay)
        for _ in range(block):
            carry = _sharded_blocked_pivot(carry, opts, stall, n_global,
                                           opts.max_iters, lay)
        _fresh_carry(_flush(carry, opts, lay), block, lay, carry.gamma)
        walked, blocks = block, 1
    elif driver == "rank1":
        walked, blocks = steps, 0
        for _ in range(walked):
            sh = _sharded_step(sh, opts, stall, n_global, lay,
                               opts.max_iters)
    else:
        raise ValueError(f"unknown driver {driver!r}")
    return {"steps": walked, "blocks": blocks, "calls": Counter(COUNTS)}


def assert_fused_psum(mesh, m=6, n=10, block=8, rule=None,
                      dtype=torch.float32) -> Dict[str, object]:
    """Check the blocked driver's communication structure (see the module
    doc) from one profiled block; returns a summary, or raises
    AssertionError with the call table when the structure regressed."""
    prof = collective_profile(mesh, m=m, n=n, block=block, rule=rule,
                              dtype=dtype)
    calls, steps = Counter(prof["calls"]), prof["steps"]
    dt = str(dtype).replace("torch.", "")
    devex = rule == RULE_DEVEX
    fused_elems = (m + 2) + block + 1 + int(devex)
    per_step = [("all_gather", "float64", 4),  # the packed pricing round
                ("psum", dt, fused_elems)]       # the fused column fetch
    if devex:
        per_step.append(("pmax", dt, 1))         # the devex frame reset
    per_block = {("psum", "int32", m): 2,        # art_basic: this block, next
                 ("psum", "int32", 2): 1}        # (ray, non-finite) at flush
    expected = Counter({k: steps for k in per_step})
    expected.update(per_block)
    assert calls[("psum", dt, m + 2)] == 0, (
        f"an UNFUSED (m+2) column psum: {dict(calls)}")
    assert calls == expected, (
        f"collectives {dict(calls)}, expected {dict(expected)}")
    return {
        "collectives_per_pivot": {f"{k}:{d}x{e}": 1 for k, d, e in per_step},
        "collectives_per_block": {f"{k}:{d}x{e}": c
                                  for (k, d, e), c in per_block.items()},
        "fused_psum_elems": fused_elems,
        "n_fused": calls[("psum", dt, fused_elems)] // steps,
        # the pricing gather, then the fetch that depends on its winner
        "dependent_rounds_per_pivot": 2,
        "bytes_per_pivot": sum(_BYTES[d] * e for k, d, e in per_step),
    }

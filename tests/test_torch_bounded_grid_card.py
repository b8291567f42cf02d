"""The solo bounded walk's cooperative launch (``bounded_grid``,
``tpulp_torch/kernels/csrc/bounded_grid.cu``) on the card against its plain
version ``bounded_grid_reference`` on the CPU: every field equal (the
tableau as ``T + 0.0``), the entering flips and upper hits too, on the
plan's grid, on forced grids of 1, 2, 3 and 7 blocks, at forced splits of
the slabs' rows (the streamed plan) and on the plan with the per-row
vectors in device memory, forced at small frames; and
``run_simplex_bounded`` on the card against the plain loop.

Every test here needs a CUDA card (the ``cuda`` marker) and skips without
one. The file imports neither jax nor tpulp, so that it runs on a machine
with the card alone: chip_smoke.py's phase 8a runs it there with
``python -m pytest --noconftest -m cuda -q -p no:cacheprovider
tests/test_torch_bounded_grid_card.py``. The walks are the CPU tests'
cases (``tests/test_torch_bounded_kernel.py``), built with the port's own
model classes."""

import dataclasses

import numpy as np
import pytest
import torch

import tpulp_torch.kernels.bounded as kb
import tpulp_torch.kernels.bounded_grid as kg
from tpulp_torch import LinExpr, LinProg
from tpulp_torch.core import SolverOptions
from tpulp_torch.core.state import RULE_DEVEX
from tpulp_torch.solve.api import state_from_standard_form
from tpulp_torch.solve.bounded import (make_bounded_state,
                                       run_simplex_bounded,
                                       run_simplex_bounded_reference)

torch.set_num_threads(1)

SLABS = (1, 2, 3, 7)
# option overrides per pricing; "bland" counts every pivot as stalled, so
# the stall switch turns Bland's rule on after the first one
RULES = {"dantzig": {}, "devex": {"rule": RULE_DEVEX},
         "bland": {"stall_limit": 1, "degen_tol": 1e30}}
# (kind, seed, m, n): plain and degenerate box LPs (upper hits,
# entering flips, stalls), the phase-1 LPs with a redundant row (the phase
# change and the retire), and the same started in phase 2 with every
# artificial basic ("cleanup": the clean-up pivots, then the retire)
CASES = [("box", 0, 12, 20), ("deg", 0, 12, 20), ("deg", 3, 30, 40),
         ("redundant", 1, 9, 16), ("redundant", 4, 15, 24),
         ("cleanup", 2, 9, 16)]


def box_lp(seed, m, n, degenerate=False):
    """A seeded box LP: every variable in [0, u_j], m rows (every third a
    >= row). ``degenerate`` draws small integers, so ratio ties and
    degenerate pivots occur; otherwise normal data."""
    rng = np.random.default_rng(seed)
    lp = LinProg(f"box{seed}")
    obj = LinExpr()
    for j in range(n):
        ub = int(rng.integers(1, 5)) if degenerate \
            else float(rng.uniform(0.5, 4.0))
        lp.addVar(f"v{j}", lb=0, ub=ub)
        cj = int(rng.integers(-5, 6)) if degenerate else float(rng.normal())
        obj += LinExpr(cj, f"v{j}")
    lp.maximize(obj)
    for i in range(m):
        e = LinExpr()
        for j in range(n):
            a = int(rng.integers(-2, 4)) if degenerate \
                else float(rng.normal())
            e += LinExpr(a, f"v{j}")
        if i % 3 == 2:
            rhs = -int(rng.integers(0, 3)) if degenerate \
                else -float(abs(rng.normal()))
            lp.addConstraint(e.constraintGeq(rhs))
        else:
            rhs = int(rng.integers(0, 8)) if degenerate \
                else float(3.0 * abs(rng.normal()))
            lp.addConstraint(e.constraintLeq(rhs))
    return lp


def redundant_box_lp(seed, m, n):
    """A box LP in phase 1: equality rows (artificials), one of them twice
    over (a redundant row, whose artificial stays basic at 0 and is
    retired in phase 2), and >= rows with positive right-hand sides."""
    rng = np.random.default_rng(seed)
    lp = LinProg(f"redundant{seed}")
    x0 = rng.uniform(0.2, 1.0, size=n)
    obj = LinExpr()
    for j in range(n):
        lp.addVar(f"v{j}", lb=0, ub=int(rng.integers(1, 4)))
        obj += LinExpr(int(rng.integers(-5, 6)), f"v{j}")
    lp.maximize(obj)
    rows = rng.integers(0, 4, size=(m, n))
    for i in range(m):
        e = LinExpr()
        for j in range(n):
            e += LinExpr(int(rows[i, j]), f"v{j}")
        rhs = float(rows[i] @ x0)
        if i % 3 == 1:
            lp.addConstraint(e.constraintGeq(round(rhs / 2, 3)))
        elif i % 3 == 2:
            lp.addConstraint(e.constraintLeq(round(rhs * 2 + 1, 3)))
        else:
            lp.addConstraint(e.constraintEq(round(rhs, 3)))
    # the first row again, doubled: a redundant equality
    e = LinExpr()
    for j in range(n):
        e += LinExpr(2 * int(rows[0, j]), f"v{j}")
    lp.addConstraint(e.constraintEq(2 * round(float(rows[0] @ x0), 3)))
    return lp


def case_lp(case):
    kind, seed, m, n = case
    if kind in ("redundant", "cleanup"):
        return redundant_box_lp(seed, m, n)
    return box_lp(seed, m, n, degenerate=kind == "deg")


def port_state(case, dtype, rule_kw):
    """(state, options) of the case's bounded walk on the CPU; "cleanup"
    starts in phase 2 with its artificials still basic and masked out of
    pricing; devex weights at 1."""
    sf = case_lp(case).lower(simple_bounds=True)
    opts = SolverOptions.for_dtype(dtype, **rule_kw)
    bs = make_bounded_state(state_from_standard_form(sf, dtype=dtype,
                                                     device="cpu"),
                            sf.upper)
    if case[0] == "cleanup":
        s = bs.s
        bs = bs._replace(s=s._replace(
            phase=torch.tensor(2, dtype=torch.int32),
            col_active=s.col_active & ~s.art_cols))
    if opts.rule == RULE_DEVEX:
        bs = bs._replace(gamma=torch.ones(bs.s.n, dtype=dtype))
    return bs, opts


def as_bits(x: torch.Tensor) -> torch.Tensor:
    """Floats as their bits after ``+ 0.0`` (NaN as one value)."""
    if not x.is_floating_point():
        return x
    ints = torch.int64 if x.dtype == torch.float64 else torch.int32
    return (torch.nan_to_num(x, nan=0.5) + 0.0).view(ints)


def assert_same_state(a, b):
    """Every field of two bounded states equal, floats as ``T + 0.0``."""
    for name in ("T", "basis", "col_active", "art_cols", "phase", "status",
                 "niter", "stuck", "bland", "last_z"):
        x, y = getattr(a.s, name), getattr(b.s, name)
        assert x.dtype == y.dtype, name
        assert torch.equal(as_bits(x), as_bits(y)), name
    assert torch.equal(a.at_upper, b.at_upper)
    assert (a.gamma is None) == (b.gamma is None)
    if a.gamma is not None:
        assert torch.equal(as_bits(a.gamma), as_bits(b.gamma))


def _moved(bs, device):
    """The bounded state ``bs`` (its simplex state's tensors and its own)
    on ``device``."""
    return bs._replace(
        s=type(bs.s)(*(x.to(device) for x in bs.s)),
        **{k: None if getattr(bs, k) is None else getattr(bs, k).to(device)
           for k in ("upper", "at_upper", "gamma")})


def _on_card(bs):
    return _moved(bs, "cuda")


def _on_cpu(bs):
    return _moved(bs, "cpu")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py's phase 8a runs this "
                    "file there)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cuda_bounded_grid_matches_its_plain_version(dtype):
    _need_card()
    tt = getattr(torch, dtype)
    for case in CASES:
        for rule in RULES:
            bs, opts = port_state(case, tt, RULES[rule])
            stall = opts.resolved_stall_limit(bs.s.m, bs.s.n)
            for blocks in SLABS:
                for budget in (400, 7):
                    before = dict(kb.FLIPS)
                    out = kg.bounded_grid(_on_card(bs), opts, stall, budget,
                                          blocks=blocks)
                    ref, counts = kg.bounded_grid_reference(
                        bs, opts, stall, budget, blocks)
                    torch.cuda.synchronize()
                    assert_same_state(_on_cpu(out), ref)
                    assert {k: kb.FLIPS[k] - before[k]
                            for k in kb.FLIPS} == counts
            out = run_simplex_bounded(_on_card(bs),
                                      dataclasses.replace(opts,
                                                          max_iters=400))
            ref = run_simplex_bounded_reference(
                bs, dataclasses.replace(opts, max_iters=400))
            assert_same_state(_on_cpu(out), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cuda_streamed_grid_matches_its_plain_version(dtype):
    """The streamed kernel at forced splits (rows 3, M // 2 and M - 1 in
    shared memory), on 1, 3 and 7 blocks, Dantzig and devex, to the exit
    and to a budget: every field equal to ``bounded_grid_reference`` (one
    walk for the three splits, which change no entry's arithmetic)."""
    _need_card()
    tt = getattr(torch, dtype)
    for case in CASES:
        for rule in ("dantzig", "devex"):
            bs, opts = port_state(case, tt, RULES[rule])
            stall = opts.resolved_stall_limit(bs.s.m, bs.s.n)
            M = bs.s.T.shape[0]
            for blocks in (1, 3, 7):
                for budget in (400, 7):
                    ref, counts = kg.bounded_grid_reference(
                        bs, opts, stall, budget, blocks)
                    for rows in (3, M // 2, M - 1):
                        before = dict(kb.FLIPS)
                        out = kg.bounded_grid(_on_card(bs), opts, stall,
                                              budget, blocks=blocks,
                                              rows=rows)
                        torch.cuda.synchronize()
                        assert_same_state(_on_cpu(out), ref)
                        assert {k: kb.FLIPS[k] - before[k]
                                for k in kb.FLIPS} == counts


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cuda_device_vector_grid_matches_its_plain_version(dtype):
    """The device-vector plan forced at the small frames (rows 3 and M - 1
    in shared memory, the RHS, basis and spans in device memory), on 1, 3
    and 7 blocks, under Dantzig, devex and Bland, to the exit and to a
    budget, and with an RHS whose |b| sum overflows: every field equal to
    ``bounded_grid_reference`` on that plan (its |b| sum's order; one
    walk for both splits), the flips too."""
    _need_card()
    tt = getattr(torch, dtype)
    for case in CASES:
        for rule in RULES:
            bs, opts = port_state(case, tt, RULES[rule])
            stall = opts.resolved_stall_limit(bs.s.m, bs.s.n)
            M = bs.s.T.shape[0]
            for blocks in (1, 3, 7):
                for budget in (400, 7):
                    state = bs
                    if budget == 7 and blocks == 3:
                        T = bs.s.T.clone()
                        T[3:5, -1] = torch.finfo(tt).max / 1.5
                        state = bs._replace(s=bs.s._replace(T=T))
                    ref, counts = kg.bounded_grid_reference(
                        state, opts, stall, budget, blocks,
                        vectors="device")
                    for rows in (3, M - 1):
                        before = dict(kb.FLIPS)
                        out = kg.bounded_grid(_on_card(state), opts, stall,
                                              budget, blocks=blocks,
                                              rows=rows, vectors="device")
                        torch.cuda.synchronize()
                        assert_same_state(_on_cpu(out), ref)
                        assert {k: kb.FLIPS[k] - before[k]
                                for k in kb.FLIPS} == counts

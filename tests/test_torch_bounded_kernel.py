"""The bounded step's four plain stages (``tpulp_torch/kernels/bounded.py``,
the parts of the grid walk's plain version): composed, the price, ratio,
update and finish stages give ``bounded_simplex_step`` bit for bit
(``T + 0.0``) in every field at f64 and f32, and tpulp's jitted bounded
step step for step at f64 (status, pivots, basis, at-upper flags, the
tableau). The walks cover Dantzig, devex and the Bland switch, upper hits
and entering flips, phase 1 with the artificials' clean-up and retire, and
budgets of 1 and 7 steps. The CUDA dispatch of ``run_simplex_bounded`` and
its CPU walk are held here too; the grid kernel runs on the card only
(``tests/test_torch_bounded_grid_card.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpulp.solve as tpulp_solve
import tpulp_torch
import tpulp_torch.kernels.bounded as kb
import tpulp_torch.kernels.bounded_grid as kg
import tpulp_torch.solve.api as papi
import tpulp_torch.solve.bounded as pbounded
from tpulp import LinExpr, LinProg
from tpulp.core.state import SolverOptions as TpulpOptions
from tpulp.solve.api import state_from_standard_form as tpulp_state
from tpulp.solve.bounded import bounded_simplex_step as tpulp_step
from tpulp.solve.bounded import make_bounded_state as tpulp_bounded
from tpulp_torch.core import SolverOptions, Status
from tpulp_torch.core.state import RULE_DEVEX
from tpulp_torch.kernels import LAUNCHES, reset_launches
from tpulp_torch.solve.api import state_from_standard_form
from tpulp_torch.solve.bounded import (bounded_simplex_step,
                                       make_bounded_state,
                                       run_simplex_bounded,
                                       run_simplex_bounded_reference)

from test_torch_bounded import RULES, box_lp
from test_torch_model import to_port

torch.set_num_threads(1)


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


# (builder, seed, m, n): plain and degenerate box LPs (upper hits,
# entering flips, stalls), the phase-1 LPs with a redundant row (the phase
# change and the retire), and the same started in phase 2 with every
# artificial basic ("cleanup": the clean-up pivots, then the retire)
CASES = [("box", 0, 12, 20), ("deg", 0, 12, 20), ("deg", 3, 30, 40),
         ("redundant", 1, 9, 16), ("redundant", 4, 15, 24),
         ("cleanup", 2, 9, 16)]
CASE_IDS = [f"{b}-{s}-{m}x{n}" for b, s, m, n in CASES]


def case_lp(case):
    kind, seed, m, n = case
    if kind in ("redundant", "cleanup"):
        return redundant_box_lp(seed, m, n)
    return box_lp(seed, m, n, degenerate=kind == "deg")


def in_phase2(s, as_phase):
    """The state ``s`` moved to phase 2 with its artificials still basic
    and masked out of pricing: the clean-up's starting point."""
    return s._replace(phase=as_phase(2),
                      col_active=s.col_active & ~s.art_cols)


def port_state(case, dtype, rule_kw):
    psf = to_port(case_lp(case)).lower(simple_bounds=True)
    opts = SolverOptions.for_dtype(dtype, **rule_kw)
    bs = make_bounded_state(state_from_standard_form(psf, dtype=dtype,
                                                     device="cpu"),
                            psf.upper)
    if case[0] == "cleanup":
        bs = bs._replace(s=in_phase2(
            bs.s, lambda v: torch.tensor(v, dtype=torch.int32)))
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


class Events:
    """What a walk went through, read from consecutive plain states."""

    def __init__(self):
        self.upper_hits = self.entering_flips = self.retires = 0
        self.cleanups = self.stalls = self.phase_changes = 0

    def see(self, old, new):
        same_basis = bool((new.s.basis == old.s.basis).all())
        flip = bool((new.at_upper != old.at_upper).any())
        moved = int(new.s.niter) > int(old.s.niter)
        self.entering_flips += moved and same_basis
        self.upper_hits += (not same_basis) and flip
        self.retires += bool((new.s.art_cols != old.s.art_cols).any())
        self.stalls += int(new.s.stuck) > int(old.s.stuck)
        self.phase_changes += int(new.s.phase) != int(old.s.phase)
        self.cleanups += (moved and int(old.s.phase) == 2 and bool(
            old.s.art_cols[old.s.basis.long()].any()))


def stage_walk(bs, opts, stall, max_iters, steps):
    """The plain step and the composed stages side by side, ``steps``
    steps (the plain step goes on past the exit, as a chunk does); every
    state held equal. Returns the events and the final record."""
    rec = kb.make_record(bs)
    ev = Events()
    for _ in range(steps):
        nxt = bounded_simplex_step(bs, opts, stall, max_iters)
        kb.bounded_step_reference(rec, opts, stall, max_iters)
        assert_same_state(kb.record_state(rec, bs), nxt)
        ev.see(bs, nxt)
        bs = nxt
    return ev, rec


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("rule", list(RULES))
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_stages_equal_the_step(case, rule, dtype):
    tt = getattr(torch, dtype)
    bs, opts = port_state(case, tt, RULES[rule])
    stall = opts.resolved_stall_limit(bs.s.m, bs.s.n)
    ev, rec = stage_walk(bs, opts, stall, None, 400)
    assert int(rec.ints[kb.STATUS]) != Status.RUNNING
    # the record's counters are the walk's entering flips and upper hits
    assert int(rec.ints[kb.N_ENTER]) == ev.entering_flips
    assert int(rec.ints[kb.N_UPHIT]) == ev.upper_hits
    if case[0] == "redundant":
        assert ev.phase_changes == 1 and ev.retires >= 1
    elif case[0] == "cleanup":
        assert ev.cleanups > 0 and ev.retires >= 1
    else:
        assert ev.upper_hits + ev.entering_flips > 0
    if rule == "bland":
        assert bool(rec.ints[kb.BLAND])


@pytest.mark.parametrize("budget", [1, 7])
@pytest.mark.parametrize("rule", ["dantzig", "devex"])
def test_stages_hold_the_budget(rule, budget):
    """Past the budget every stage is a no-op: the record stops where the
    plain step freezes, status RUNNING and ``niter`` at the budget."""
    bs, opts = port_state(CASES[1], torch.float64, RULES[rule])
    stall = opts.resolved_stall_limit(bs.s.m, bs.s.n)
    _, rec = stage_walk(bs, opts, stall, budget, budget + 5)
    assert int(rec.ints[kb.NITER]) == budget
    assert int(rec.ints[kb.STATUS]) == Status.RUNNING


def test_every_event_is_covered():
    """The cases above walk through every kind of step the stages split:
    upper hits, entering flips, stalls, the clean-up pivot or retire and
    the phase change."""
    total = Events()
    for case in CASES:
        for rule in ("dantzig", "devex"):
            bs, opts = port_state(case, torch.float64, RULES[rule])
            stall = opts.resolved_stall_limit(bs.s.m, bs.s.n)
            ev, _ = stage_walk(bs, opts, stall, None, 400)
            for k, v in vars(ev).items():
                setattr(total, k, getattr(total, k) + v)
    assert total.upper_hits and total.entering_flips and total.stalls
    assert total.retires and total.phase_changes and total.cleanups


@pytest.mark.parametrize("rule", list(RULES))
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_stages_equal_tpulp_step_for_step(case, rule):
    """At f64 the composed stages walk tpulp's jitted bounded step: status,
    pivots, basis, at-upper flags and the tableau (``T + 0.0``) after
    every step."""
    sf = case_lp(case).lower(simple_bounds=True)
    jo = TpulpOptions.for_dtype(jnp.float64, **RULES[rule])
    js = tpulp_bounded(tpulp_state(sf), sf.upper)
    if case[0] == "cleanup":
        js = js._replace(s=in_phase2(js.s, lambda v: jnp.int32(v)))
    if jo.rule == RULE_DEVEX:
        js = js._replace(gamma=jnp.ones((js.s.n,), jnp.float64))
    bs, opts = port_state(case, torch.float64, RULES[rule])
    stall = jo.resolved_stall_limit(js.s.m, js.s.n)
    step = jax.jit(lambda b: tpulp_step(b, jo, stall))
    rec = kb.make_record(bs)
    for _ in range(400):
        js = step(js)
        kb.bounded_step_reference(rec, opts, stall, None)
        ps = kb.record_state(rec, bs)
        jT = torch.from_numpy(np.array(js.s.T))
        assert torch.equal(as_bits(ps.s.T), as_bits(jT))
        assert np.array_equal(ps.at_upper.numpy(), np.asarray(js.at_upper))
        for name in ("basis", "status", "niter", "phase", "bland"):
            assert np.array_equal(getattr(ps.s, name).numpy(),
                                  np.asarray(getattr(js.s, name))), name
        if int(ps.s.status) != Status.RUNNING:
            break
    assert int(ps.s.status) != Status.RUNNING


def stage_driver(bs, opts=None):
    """``run_simplex_bounded`` with the composed stages in place of the
    step: the kernels' walk, in their order, on the CPU."""
    if opts is None:
        opts = SolverOptions.for_dtype(bs.s.T.dtype)
    bs = pbounded._with_gamma(bs, opts)
    stall = opts.resolved_stall_limit(bs.s.m, bs.s.n)
    rec = kb.make_record(bs)
    while kb._live(rec.ints.tolist(), opts.max_iters):
        kb.bounded_step_reference(rec, opts, stall, opts.max_iters)
    return pbounded._finish(kb.record_state(rec, bs))


@pytest.mark.parametrize("pricing", ["dantzig", "devex"])
@pytest.mark.parametrize("case", [CASES[0], CASES[3]], ids=["box", "redundant"])
def test_f32_stage_solve_matches_tpulp(case, pricing, monkeypatch):
    """At f32 the stages' walk, under ``solve_lp``, gives tpulp's status,
    rung and exact objective."""
    monkeypatch.setattr(papi, "run_simplex_bounded", stage_driver)
    lp = case_lp(case)
    ref = tpulp_solve.solve_lp(lp, simple_bounds=True, dtype=jnp.float32,
                               pricing=pricing)
    out = tpulp_torch.solve_lp(to_port(lp), simple_bounds=True,
                               dtype=torch.float32, pricing=pricing,
                               device="cpu")
    assert out.status == ref.status
    assert out.objective == ref.objective and out.rung == ref.rung


# ---------------------------------------------------------------------------
# the dispatch
# ---------------------------------------------------------------------------

def _small():
    bs, opts = port_state(CASES[0], torch.float64, {})
    return bs, opts


def test_dispatch_hands_the_kernels_a_contiguous_tableau(monkeypatch):
    """``run_simplex_bounded`` takes a strided tableau on either device (as
    tpulp's does): on the card it hands the kernel of ``bounded_route``
    (``bounded_grid``, which refuses one) a contiguous copy (the CUDA
    dispatch, ``on_cpu`` patched)."""
    seen = []

    def spy(bs, opts, stall_limit, max_iters):
        seen.append(bs.s.T)
        return bs

    monkeypatch.setattr(pbounded, "on_cpu", lambda *tensors: False)
    monkeypatch.setattr(pbounded, "sm_count", lambda device: 132)
    monkeypatch.setattr(pbounded, "bounded_grid", spy)
    bs, opts = _small()
    strided = bs._replace(s=bs.s._replace(T=bs.s.T.t().contiguous().t()))
    assert not strided.s.T.is_contiguous()
    out = run_simplex_bounded(strided, opts)
    (T,) = seen
    assert T.is_contiguous() and torch.equal(T, bs.s.T)
    assert torch.equal(out.s.T, bs.s.T)


def test_cpu_walk_never_reaches_the_kernel(monkeypatch):
    """On CPU tensors ``run_simplex_bounded`` is the plain loop: a wrapper
    that raises is never called, no launch is counted, and the walk is
    ``run_simplex_bounded_reference``'s."""
    def refuse(*args, **kw):
        raise AssertionError("the bounded kernel was called on the CPU")

    monkeypatch.setattr(pbounded, "bounded_grid", refuse)
    monkeypatch.setattr(kg, "bounded_grid", refuse)
    reset_launches()
    bs, opts = port_state(CASES[1], torch.float64, {"rule": RULE_DEVEX})
    bs = bs._replace(gamma=None)
    out = run_simplex_bounded(bs, opts)
    ref = run_simplex_bounded_reference(bs, opts)
    assert_same_state(out, ref)
    assert int(out.s.status) == Status.OPTIMAL
    sol = tpulp_torch.solve_lp(to_port(case_lp(CASES[1])),
                               simple_bounds=True, device="cpu")
    assert sol.status == "optimal"
    assert LAUNCHES["bounded_grid"] == 0


def test_constants_shared_with_the_plain_step():
    assert pbounded.DEVEX_RESET_ABOVE == kb.DEVEX_RESET_ABOVE == 1e8
    assert pbounded.BIG_I == kb.BIG_I == 2 ** 30

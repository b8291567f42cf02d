"""The solo rank-K blocked engine on the card (``tpulp_torch/kernels/
blocked.py``), held on the CPU through its plain versions: composed, the
cleanup, price, column, ratio, row and finish stages walk the eager
``_blocked_pivot`` slot for slot, and a block of them with the flush and the
ray stage walks the eager block (``solve.blocked._flush``), under Dantzig,
Bland, devex, largest-pivot ties and the stall switch, through the
clean-up pivots, the retire, the phase change, devex's resets, the budget
and the exits; the plain-stage walk ends where tpulp's ``run_simplex_blocked``
does at f64. The wrapper's refusals and ``run_simplex_blocked``'s dispatch
are held here too. The kernels run on the card only (the ``cuda`` test;
chip_smoke.py's phase 5d holds them at full size).

Tolerances: the plain stages sum the eta corrections in slot order, one fma
a slot; the eager pivot's matrix products sum in the library's order. That
order is the only difference, so decisions, integers and flags are held
equal and the floats to ``TOL`` (a few ulps of values below ~1e3 after at
most K = 8 products a sum: 1e-12 at f64, 1e-4 at f32). At f32 the two
orders part by an ulp often enough for a near-tie to pick another column
within a walk, so each f32 slot is held from the same state (the eager
carry rebuilt from the plain record), and the whole walk at f64."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpulp_torch.kernels.blocked as kb
from tpulp.core import make_state as tpulp_make_state
from tpulp.core.state import SolverOptions as TpulpOptions
from tpulp.solve import run_simplex_blocked as tpulp_blocked
from tpulp_torch.core import SolverOptions, Status, from_numpy_state
from tpulp_torch.core.state import (RULE_BLAND, RULE_DEVEX, TIE_MAXPIV,
                                    eta_scaled_options)
from tpulp_torch.kernels import LAUNCHES, reset_launches
from tpulp_torch.kernels.block import fused_flush_reference
from tpulp_torch.solve import blocked as pb

from test_torch_bounded_kernel import as_bits
from test_torch_drivers import _beale, _cleanup, _random
from test_torch_rank1_kernel import (_equalities, _infeasible, _numeric,
                                     _ray, _wyndor)

torch.set_num_threads(1)

K = 4


def _tiny_pivot():
    """min -x s.t. 1e-5 x + y + s1 = 1, x + s2 = 10^6: devex's first pivot
    on 1e-5 leaves a weight of 1e10, past the 1e8 reset."""
    A = np.array([[1e-5, 1.0, 1.0, 0.0], [1.0, 0.0, 0.0, 1.0]])
    return np.array([-1.0, -0.5, 0.0, 0.0]), A, np.array([1.0, 1e6]), [2, 3]


# phase 2 from a slack basis (optimal, unbounded, Beale's cycling LP, a
# longer walk, a ray the per-block scan exposes), phase 1 with the clean-up
# pivots and a retire, infeasible, NUMERIC, a pivot on 1e-5
INSTANCES = {
    "random0": lambda: _random(0),
    "bounded1": lambda: _random(1, bounded=True),
    "beale": _beale,
    "cleanup": _cleanup,
    "equalities": lambda: _equalities(5),
    "long": lambda: _random(3, m=24, n=40, bounded=True),
    "infeasible": _infeasible,
    "numeric": _numeric,
    "ray": _ray,
    "tiny_pivot": _tiny_pivot,
}
RULES = {
    "dantzig": {},
    "bland": {"rule": RULE_BLAND},
    "devex": {"rule": RULE_DEVEX},
    "maxpiv": {"tie_break": TIE_MAXPIV},
    "devex_maxpiv": {"rule": RULE_DEVEX, "tie_break": TIE_MAXPIV},
    "stall_bland": {"stall_limit": 1, "degen_tol": 1e30},
}
TOL = {torch.float64: 1e-12, torch.float32: 1e-4}
BLOCKS = 200


def port_state(instance, dtype):
    c, A, b, hint = INSTANCES[instance]()
    return from_numpy_state(tpulp_make_state(c, A, b, hint, _numpy=True,
                                             dtype=jnp.float64),
                            device="cpu", dtype=dtype)


def options(rule, dtype, **kw):
    return eta_scaled_options(SolverOptions.for_dtype(
        dtype, **RULES[rule], **kw), dtype)


def eager_carry(rec):
    """The eager engine's carry of the plain record (copies)."""
    rec = kb.clone_record(rec)
    return pb._BlockCarry(s=kb.record_state(rec), U=rec.U, V=rec.V,
                          t=rec.ints[kb.SLOT].clone(), row0=rec.row0,
                          row1=rec.row1, bvec=rec.bvec, gamma=rec.gamma)


def close(a, b, tol):
    """Equal within ``tol`` (relative above 1), NaN and infinities equal."""
    assert a.dtype == b.dtype and a.shape == b.shape
    if not a.is_floating_point():
        return bool(torch.equal(a, b))
    fin = torch.isfinite(a) & torch.isfinite(b)
    if not torch.equal(fin, torch.isfinite(a)) or not torch.equal(
            torch.nan_to_num(a[~fin], nan=0.5),
            torch.nan_to_num(b[~fin], nan=0.5)):
        return False
    d = (a[fin] - b[fin]).abs()
    return bool((d <= tol * torch.clamp_min(b[fin].abs(), 1.0)).all())


def assert_slot(carry, rec, tol, where):
    """The eager carry and the plain record after the same slot: every
    integer field and flag equal, the floats within ``tol``."""
    s = kb.record_state(rec)
    for name in ("basis", "col_active", "art_cols", "phase", "status",
                 "niter", "stuck", "bland"):
        assert torch.equal(getattr(carry.s, name), getattr(s, name)), \
            (where, name)
    assert int(carry.t) == int(rec.ints[kb.SLOT]), (where, "t")
    for name in ("U", "V", "row0", "row1", "bvec", "gamma"):
        assert close(getattr(carry, name), getattr(rec, name), tol), \
            (where, name)
    assert close(carry.s.last_z, s.last_z, tol), (where, "last_z")


class Events:
    """What a walk went through, read from the plain record before and
    after each slot and block."""

    KINDS = ("cleanups", "retires", "phase_changes", "devex_resets",
             "resets_1e8", "bland_switches", "budget_stops", "optimal",
             "unbounded", "rays", "infeasible", "numeric")

    def __init__(self):
        self.seen = dict.fromkeys(self.KINDS, 0)

    def slot(self, before, rec, devex):
        b, a = before.ints.tolist(), rec.ints.tolist()
        if b[kb.STATUS] != Status.RUNNING:
            return
        moved = a[kb.NITER] > b[kb.NITER]
        self.seen["cleanups"] += moved and bool(a[kb.DO_CLEANUP])
        self.seen["retires"] += bool(a[kb.RETIRE])
        self.seen["phase_changes"] += a[kb.PHASE] != b[kb.PHASE]
        self.seen["devex_resets"] += devex and bool(a[kb.TO_PHASE2])
        # the row stage's maxima of the weights, before the finish resets
        M, N = rec.T.shape
        G = kb.partials(M, N)
        self.seen["resets_1e8"] += devex and bool(
            rec.scratch[M + N:M + N + G].max() > kb.RESET_ABOVE)
        self.seen["bland_switches"] += bool(a[kb.BLAND]) and not b[kb.BLAND]
        self.seen["budget_stops"] += (bool(a[kb.DO_CLEANUP] or
                                           a[kb.DO_PRICING])
                                      and not a[kb.ACT])
        for kind, code in (("optimal", Status.OPTIMAL),
                           ("unbounded", Status.UNBOUNDED),
                           ("infeasible", Status.INFEASIBLE),
                           ("numeric", Status.NUMERIC)):
            self.seen[kind] += a[kb.STATUS] == code

    def block(self, rec):
        self.seen["rays"] += int(rec.ints[kb.RAY])


def walk_against_eager(state, opts, max_iters, resync, events=None,
                       devex=False):
    """The plain stages and the eager engine side by side in blocks of K:
    each slot held against ``_blocked_pivot`` (from the same state when
    ``resync``, else in lockstep), each block's end against ``_flush``.
    Returns the final record."""
    stall = opts.resolved_stall_limit(state.m, state.n)
    tol = TOL[state.T.dtype]
    rec = kb.make_record(state, K)
    carry = pb._fresh_carry(state, K)
    for blk in range(BLOCKS):
        status, niter = rec.ints[kb.STATUS:kb.NITER + 1].tolist()
        assert (status, niter) == (int(carry.s.status), int(carry.s.niter))
        if status != Status.RUNNING or niter >= max_iters:
            return rec
        for slot in range(K):
            if resync:
                carry = eager_carry(rec)
            before = kb.clone_record(rec)
            carry = pb._blocked_pivot(carry, opts, stall, max_iters)
            kb.blocked_pivot_reference(rec, opts, stall, max_iters)
            assert_slot(carry, rec, tol, (blk, slot))
            if events is not None:
                events.slot(before, rec, devex)
        s = pb._flush(carry, opts)
        _, scan = fused_flush_reference(*kb.flush_inputs(rec),
                                        float(opts.opt_tol),
                                        float(opts.piv_tol))
        kb.blocked_ray_reference(rec, scan, opts)
        assert close(s.T, rec.T, tol), (blk, "T")
        assert int(s.status) == int(rec.ints[kb.STATUS]), (blk, "ray")
        if events is not None:
            events.block(rec)
        carry = pb._fresh_carry(s, K, carry.gamma)
    raise AssertionError(f"no exit in {BLOCKS} blocks")


@pytest.mark.parametrize("rule", list(RULES))
@pytest.mark.parametrize("instance", list(INSTANCES))
def test_stages_walk_the_eager_engine_f64(instance, rule):
    state = port_state(instance, torch.float64)
    opts = options(rule, torch.float64)
    rec = walk_against_eager(state, opts, opts.max_iters, resync=False)
    assert int(rec.ints[kb.STATUS]) != Status.RUNNING


@pytest.mark.parametrize("rule", ["dantzig", "bland", "devex", "maxpiv"])
@pytest.mark.parametrize("instance", ["bounded1", "cleanup", "equalities",
                                      "long", "ray"])
def test_stages_equal_the_eager_pivot_f32(instance, rule):
    state = port_state(instance, torch.float32)
    opts = options(rule, torch.float32)
    walk_against_eager(state, opts, opts.max_iters, resync=True)


@pytest.mark.parametrize("budget", [1, 5, 6, 13])
@pytest.mark.parametrize("rule", ["dantzig", "devex"])
def test_budget_stops_inside_a_block(rule, budget):
    """A budget that is not a multiple of K ends the walk in the middle of
    a block: the slots past it pivot nowhere, as the eager engine's; the
    walks agree slot for slot, and the plain walk's exit is the eager
    engine's and tpulp's (status, pivots, basis)."""
    state = port_state("long", torch.float64)
    opts = options(rule, torch.float64, max_iters=budget)
    rec = walk_against_eager(state, opts, budget, resync=False)
    assert int(rec.ints[kb.NITER]) == budget
    out = pb.finish(kb.record_state(rec))
    c, A, b, hint = INSTANCES["long"]()
    ref = tpulp_blocked(
        tpulp_make_state(c, A, b, hint, dtype=jnp.float64),
        TpulpOptions.for_dtype(jnp.float64, max_iters=budget,
                               **RULES[rule]), block=K)
    assert int(out.status) == int(ref.status) == Status.ITERATION_LIMIT
    assert int(out.niter) == int(ref.niter) == budget
    assert np.array_equal(out.basis.numpy(), np.asarray(ref.basis))


def test_a_slot_past_the_budget_still_ends_the_walk():
    """A budget reached by the last pivot of a walk, inside a block: the
    next slot pivots nowhere but finds the optimum, as the eager engine's
    and tpulp's do; the walk ends OPTIMAL, not at the iteration limit."""
    state = port_state("long", torch.float64)
    opts = options("dantzig", torch.float64)
    full = pb.run_simplex_blocked_reference(state, opts, K)
    budget = int(full.niter)
    assert int(full.status) == Status.OPTIMAL and budget % K != 0
    opts = dataclasses.replace(opts, max_iters=budget)
    rec = walk_against_eager(state, opts, budget, resync=False)
    assert int(rec.ints[kb.STATUS]) == Status.OPTIMAL
    assert int(rec.ints[kb.NITER]) == budget


def test_every_event_is_covered():
    """The instances walk through every kind of slot the stages split: the
    clean-up pivot and the retire, the phase change with devex's reset, the
    1e8 reset, the stall switch to Bland, a budget stop inside a block,
    the optimal, unbounded (by the ratio test and by the per-block ray
    scan), infeasible and NUMERIC exits."""
    ev = Events()
    for instance in INSTANCES:
        for rule in ("dantzig", "devex", "stall_bland"):
            state = port_state(instance, torch.float64)
            opts = options(rule, torch.float64)
            walk_against_eager(state, opts, opts.max_iters, False, ev,
                               devex=rule == "devex")
    state = port_state("long", torch.float64)
    walk_against_eager(state, options("dantzig", torch.float64,
                                      max_iters=6), 6, False, ev)
    missing = [k for k, v in ev.seen.items() if not v]
    assert not missing, (missing, ev.seen)


def test_ray_stage_gate():
    """The ray stage's verdict on a scan with an exposed ray: UNBOUNDED in
    phase 2 with no artificial basic, not while one is basic, not in phase
    1, not after the walk has ended; and the carry reset either way."""
    state = port_state("cleanup", torch.float64)
    opts = options("dantzig", torch.float64)
    N = state.T.shape[1]
    scan = torch.zeros((2, N), dtype=torch.int32)
    scan[0, 1] = 1
    scan[1, 0] = 1
    for phase, art_row, status, want in (
            (2, kb.BIG_I, Status.RUNNING, Status.UNBOUNDED),
            (2, 0, Status.RUNNING, Status.RUNNING),
            (1, kb.BIG_I, Status.RUNNING, Status.RUNNING),
            (2, kb.BIG_I, Status.OPTIMAL, Status.OPTIMAL)):
        rec = kb.make_record(state, K)
        rec.ints[kb.PHASE], rec.ints[kb.ART_ROW] = phase, art_row
        rec.ints[kb.STATUS], rec.ints[kb.SLOT] = status, 3
        rec.U.fill_(1.0)
        rec.row0.fill_(7.0)
        kb.blocked_ray_reference(rec, scan, opts)
        assert int(rec.ints[kb.STATUS]) == want
        assert int(rec.ints[kb.RAY]) == (want == Status.UNBOUNDED
                                         and status == Status.RUNNING)
        assert int(rec.ints[kb.SLOT]) == 0 and not bool(rec.U.any())
        assert torch.equal(rec.row0, rec.T[0])


@pytest.mark.parametrize("rule", ["dantzig", "bland", "devex"])
@pytest.mark.parametrize("instance", ["random0", "bounded1", "beale",
                                      "cleanup"])
def test_plain_walk_matches_tpulp_f64(instance, rule):
    """As tests/test_torch_drivers.py holds the eager engine: the
    plain-stage walk ends with tpulp's status, pivots and basis, the
    objective within 1e-9."""
    c, A, b, hint = INSTANCES[instance]()
    js = tpulp_make_state(c, A, b, hint, dtype=jnp.float64)
    ref = tpulp_blocked(js, TpulpOptions.for_dtype(
        jnp.float64, max_iters=2000, **RULES[rule]), block=8)
    state = port_state(instance, torch.float64)
    opts = options(rule, torch.float64, max_iters=2000)
    stall = opts.resolved_stall_limit(state.m, state.n)
    out, _ = kb.blocked_walk_reference(state, opts, stall, opts.max_iters, 8)
    out = pb.finish(out)
    assert int(out.status) == int(ref.status)
    assert int(out.niter) == int(ref.niter)
    assert np.array_equal(out.basis.numpy(), np.asarray(ref.basis))
    if int(ref.status) == Status.OPTIMAL:
        assert abs(float(out.objective()) - float(ref.objective())) < 1e-9


def test_block_sum_is_the_grid_reduction_tree():
    """``_block_sum`` adds a block's 256 values as the launches' block
    reduction does: warps by the shuffle tree, then the warps' sums."""
    x = torch.tensor(np.random.default_rng(0).normal(size=(2, 256)))

    def tree(v):
        v = list(v)
        for off in (16, 8, 4, 2, 1):
            v = [v[i] + v[i + off] for i in range(off)]
        return v[0]

    for g in range(2):
        warps = [tree(x[g, w * 32:(w + 1) * 32].tolist()) for w in range(8)]
        assert float(kb._block_sum(x)[g]) == tree(warps + [0.0] * 24)


def test_the_callers_tableau_is_never_written():
    state = port_state("equalities", torch.float64)
    before = state.T.clone()
    opts = options("devex", torch.float64)
    stall = opts.resolved_stall_limit(state.m, state.n)
    out, _ = kb.blocked_walk_reference(state, opts, stall, opts.max_iters, K)
    assert int(out.status) == Status.OPTIMAL
    assert torch.equal(state.T, before) and out.T.data_ptr() != \
        state.T.data_ptr()


# ---------------------------------------------------------------------------
# the wrapper and the dispatch
# ---------------------------------------------------------------------------

def _small():
    return port_state("bounded1", torch.float64), \
        options("dantzig", torch.float64)


def test_blocked_steps_raises_on_cpu_tensors():
    state, opts = _small()
    with pytest.raises(ValueError, match="CUDA"):
        kb.blocked_steps(state, opts, 10, 10, K)


def test_blocked_steps_raises_on_mixed_devices():
    state, opts = _small()
    with pytest.raises(ValueError, match="CUDA"):
        kb.blocked_steps(state._replace(basis=state.basis.to("meta")), opts,
                         10, 10, K)


def test_blocked_steps_raises_on_float16():
    state, opts = _small()
    half = state._replace(T=state.T.half(), last_z=state.last_z.half())
    with pytest.raises(ValueError, match="float32 or float64"):
        kb.blocked_steps(half, opts, 10, 10, K)


def test_blocked_steps_raises_on_a_strided_tableau():
    state, opts = _small()
    strided = state._replace(T=state.T.t().contiguous().t())
    assert not strided.T.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        kb.blocked_steps(strided, opts, 10, 10, K)


def test_blocked_steps_raises_on_a_block_past_the_kernels():
    state, opts = _small()
    with pytest.raises(ValueError, match="block"):
        kb.blocked_steps(state, opts, 10, 10, kb.MAX_K + 1)


def test_record_launches_raise_on_cpu_records():
    state, opts = _small()
    rec = kb.make_record(state, K)
    with pytest.raises(ValueError, match="CUDA"):
        kb.blocked_stage(rec, "price", opts, 10, 10)
    with pytest.raises(ValueError, match="CUDA"):
        kb.enqueue_slots(rec, opts, 10, 10, 1)
    assert LAUNCHES["blocked_step"] == LAUNCHES["blocked_stage"] == 0


def test_cuda_dispatch_takes_the_kernels_with_no_fallback(monkeypatch):
    """``run_simplex_blocked`` on a state it must treat as on the card
    (``on_cpu`` patched), on the ``blocked_step`` route (``blocked_route``
    patched; tests/test_torch_blocked_cluster.py holds the route itself):
    ``blocked_steps`` gets a contiguous tableau, the eager loop is never
    entered, its error propagates, and a RUNNING exit becomes
    ITERATION_LIMIT."""
    def refuse(*args, **kw):
        raise AssertionError("the eager loop ran for a CUDA state")

    seen = []

    def spy(state, opts, stall_limit, max_iters, block):
        seen.append((state.T.is_contiguous(), state.T.data_ptr(),
                     stall_limit, max_iters, block, opts.piv_tol))
        return state, None

    monkeypatch.setattr(pb, "on_cpu", lambda *t: False)
    monkeypatch.setattr(pb, "blocked_route", lambda *a: "blocked_step")
    monkeypatch.setattr(pb, "run_simplex_blocked_reference", refuse)
    monkeypatch.setattr(pb, "_blocked_pivot", refuse)
    monkeypatch.setattr(pb, "blocked_steps", spy)
    state, _ = _small()
    strided = state._replace(T=state.T.t().contiguous().t())
    out = pb.run_simplex_blocked(strided, SolverOptions.for_dtype(
        torch.float64, max_iters=77), block=16)
    assert len(seen) == 1
    contiguous, ptr, stall, max_iters, block, _ = seen[0]
    assert contiguous and ptr != strided.T.data_ptr()
    assert (stall, max_iters, block) == (state.m + state.n, 77, 16)
    assert int(out.status) == Status.ITERATION_LIMIT
    # f32: the eta-scaled ratio tolerance reaches the kernels
    pb.run_simplex_blocked(from_numpy_state(
        [x.numpy() for x in state], device="cpu", dtype=torch.float32))
    assert seen[1][5] == 1e-4

    def fail(*args, **kw):
        raise RuntimeError("tpulp_torch blocked step: CUDA error 1")

    monkeypatch.setattr(pb, "blocked_steps", fail)
    with pytest.raises(RuntimeError, match="blocked step"):
        pb.run_simplex_blocked(state)


def test_cpu_walks_never_reach_a_kernel(monkeypatch):
    """On CPU tensors ``run_simplex_blocked`` is the eager loop, bit for
    bit, with no launch counted; the solve_lp paths through it too."""
    import tpulp_torch

    def refuse(*args, **kw):
        raise AssertionError("a kernel route was taken on the CPU")

    monkeypatch.setattr(pb, "blocked_steps", refuse)
    monkeypatch.setattr(kb, "blocked_steps", refuse)
    reset_launches()
    for instance in ("equalities", "long"):
        for rule in ("dantzig", "devex"):
            state = port_state(instance, torch.float64)
            opts = options(rule, torch.float64)
            out = pb.run_simplex_blocked(state, opts, block=K)
            ref = pb.run_simplex_blocked_reference(state, opts, block=K)
            for name in out._fields:
                assert torch.equal(as_bits(getattr(out, name)),
                                   as_bits(getattr(ref, name))), name
    lp = _wyndor(12)
    for driver in ("blocked", "refreshed"):
        sol = tpulp_torch.solve_lp(lp, device="cpu", driver=driver,
                                   pricing="devex")
        assert sol.objective == 400
    assert all(v == 0 for v in LAUNCHES.values())


# ---------------------------------------------------------------------------
# on a card only: the kernels against the plain stages and the plain walk
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cuda_blocked_kernels_match_the_plain_walk(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py's phase 5d runs these "
                    "checks at full size)")
    from tpulp_torch.kernels.block import fused_flush

    tt = getattr(torch, dtype)
    for instance in INSTANCES:
        for rule in RULES:
            state = port_state(instance, tt)
            state = type(state)(*(x.cuda() for x in state))
            opts = options(rule, tt, max_iters=500)
            stall = opts.resolved_stall_limit(state.m, state.n)
            out, g = kb.blocked_steps(state, opts, stall, opts.max_iters, K)
            ref, gr = kb.blocked_walk_reference(state, opts, stall,
                                                opts.max_iters, K,
                                                flush=fused_flush)
            torch.cuda.synchronize()
            for name in out._fields:
                assert torch.equal(as_bits(getattr(out, name).cpu()),
                                   as_bits(getattr(ref, name).cpu())), name
            assert torch.equal(as_bits(g.cpu()), as_bits(gr.cpu()))
            _cuda_stages(kb.make_record(state, K), opts, stall)


def _cuda_stages(rec, opts, stall):
    """Each launch against its plain stage on the first blocks."""
    from tpulp_torch.kernels.block import fused_flush

    for _ in range(3):
        for _ in range(K):
            for stage in kb.SLOT_STAGES:
                k, p = kb.clone_record(rec), kb.clone_record(rec)
                kb.blocked_stage(k, stage, opts, stall, opts.max_iters)
                kb.blocked_stage_reference(p, stage, opts, stall,
                                           opts.max_iters)
                torch.cuda.synchronize()
                for (name, a), (_, b) in zip(kb.record_tensors(k),
                                             kb.record_tensors(p)):
                    assert torch.equal(as_bits(a.cpu()),
                                       as_bits(b.cpu())), (stage, name)
                rec = p
        _, scan = fused_flush(*kb.flush_inputs(rec), float(opts.opt_tol),
                              float(opts.piv_tol))
        k, p = kb.clone_record(rec), kb.clone_record(rec)
        kb.blocked_stage(k, "ray", opts, stall, opts.max_iters, scan)
        kb.blocked_ray_reference(p, scan, opts)
        torch.cuda.synchronize()
        for (name, a), (_, b) in zip(kb.record_tensors(k),
                                     kb.record_tensors(p)):
            assert torch.equal(as_bits(a.cpu()), as_bits(b.cpu())), \
                ("ray", name)
        rec = p

"""The solo rank-K blocked engine's launches on the card against their
plain versions on the CPU (each block flushed by the card's B1, which the
launches' walks run too: ``card_flush``): ``blocked_grid`` (``tpulp_torch/kernels/csrc/
blocked_grid.cu``) on the plan's grid and on forced grids of 1, 2, 3 and 7
blocks, with every slot of the factors' slabs in shared memory, with none
(``resident=0``: every slot read and written in the record's U and V in
device memory) and with some, and with the running vectors, the basis and
the artificial bits in device memory (``vectors="device"``); the cluster
launch (``blocked_cluster``) at every cluster size and with a lane axis
(``blocked_cluster_batch``); the ray launch that ends each block
(``kernels.blocked.blocked_ray``). Every field equal (the tableau as ``T +
0.0``, NaN equal to NaN), the devex weights too, under Dantzig, Bland,
devex, largest-pivot ties and the stall switch, through the clean-up
pivots and the retire, the phase change, the 1e8 reset, a budget inside a
block and the exits; every instance and rule of the CPU tests' plain
stages walked on the grid and held to the plain-stage walk.

Every test here needs a CUDA card (the ``cuda`` marker) and skips without
one. The file imports neither jax nor tpulp, so that it runs on a machine
with the card alone: chip_smoke.py's phase 5d runs it there with
``python -m pytest --noconftest -m cuda -q -p no:cacheprovider
tests/test_torch_blocked_card.py``. The walks are the CPU tests' instances
(``tests/test_torch_blocked_kernel.py``, ``tests/test_torch_blocked_batch_
kernel.py``), built with the port's own state builders and model
classes."""

import numpy as np
import pytest
import torch

import tpulp_torch.kernels.blocked as kb
import tpulp_torch.kernels.blocked_cluster as kbc
import tpulp_torch.kernels.blocked_grid as kg
from tpulp_torch import LinExpr, LinProg
from tpulp_torch.batch import make_batched_states
from tpulp_torch.core import SolverOptions, Status, make_state
from tpulp_torch.core.state import (RULE_BLAND, RULE_DEVEX, TIE_MAXPIV,
                                    eta_scaled_options)

torch.set_num_threads(1)

K = 4
GRIDS = (1, 2, 3, 7)


# ---------------------------------------------------------------------------
# the instances (tests/test_torch_blocked_kernel.py's, numpy and the port)
# ---------------------------------------------------------------------------

def _random(seed, m=12, n=20, bounded=False):
    """A random instance on a slack basis; ``bounded`` adds a sum(x) row so
    the optimum exists."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n))
    x0 = np.abs(rng.normal(size=n))
    b = A @ x0 + np.abs(rng.normal(size=m))
    c = rng.normal(size=n)
    if bounded:
        A[-1] = 1.0
        b[-1] = 2.0 * x0.sum()
    Af = np.concatenate([A, np.eye(m)], axis=1)
    cf = np.concatenate([c, np.zeros(m)])
    return cf, Af, b, list(range(n, n + m))


def _lowered(lp):
    sf = lp.lower()
    c, A, b = sf.to_dense(np.float64)
    return c, A, b, sf.basis_hint


def _beale():
    """Beale's cycling LP."""
    lp = LinProg()
    for v in ["x4", "x5", "x6", "x7"]:
        lp.addVar(v)
    lp.minimize(LinExpr("-3/4", "x4", 150, "x5", "-1/50", "x6", 6, "x7"))
    lp.addConstraint(LinExpr("1/4", "x4", -60, "x5", "-1/25", "x6", 9, "x7")
                     .constraintLeq(0))
    lp.addConstraint(LinExpr("1/2", "x4", -90, "x5", "-1/50", "x6", 3, "x7")
                     .constraintLeq(0))
    lp.addConstraint(LinExpr(1, "x6").constraintLeq(1))
    return _lowered(lp)


def _cleanup():
    """Phase 1 leaves a dependent row: artificial cleanup and retirement."""
    lp = LinProg()
    lp.addVar("x")
    lp.addVar("y")
    lp.minimize(LinExpr(2, "x", 3, "y"))
    lp.addConstraint(LinExpr(1, "x", 1, "y").constraintGeq(4))
    lp.addConstraint(LinExpr(1, "x", -1, "y").constraintEq(0))
    lp.addConstraint(LinExpr(2, "x", 2, "y").constraintGeq(8))
    return _lowered(lp)


def _equalities(seed, m=10, n=14):
    """An equality LP on artificials whose last two rows are 2 x row 0 and
    row 1 + row 2: phase 1, the clean-up pivots and a retire."""
    rng = np.random.default_rng(seed)
    A = rng.integers(0, 4, size=(m - 2, n)).astype(float)
    x0 = rng.integers(1, 4, size=n) * (rng.random(n) < 0.5)
    A = np.vstack([A, 2 * A[0], A[1] + A[2]])
    return rng.integers(-5, 6, size=n).astype(float), A, A @ x0, [-1] * m


def _infeasible():
    """x + y <= 1 and x + y >= 3 (a surplus row on an artificial)."""
    A = np.array([[1.0, 1.0, 1.0, 0.0], [1.0, 1.0, 0.0, -1.0]])
    return np.array([-1.0, -1.0, 0.0, 0.0]), A, np.array([1.0, 3.0]), \
        [2, -1]


def _numeric():
    """An overflowing |b| sum: NUMERIC at the first step."""
    c, A, b, hint = _random(4)
    b[3] = np.inf
    return c, A, b, hint


def _ray():
    """A phase-2 start with an improving column that has no positive
    entry: the per-block ray scan exposes it."""
    c, A, b, hint = _random(5, bounded=True)
    A[:, 2] = -np.abs(A[:, 2])
    c[2] = -3.0
    return c, A, b, hint


def _tiny_pivot():
    """min -x s.t. 1e-5 x + y + s1 = 1, x + s2 = 10^6: devex's first pivot
    on 1e-5 leaves a weight of 1e10, past the 1e8 reset."""
    A = np.array([[1e-5, 1.0, 1.0, 0.0], [1.0, 0.0, 0.0, 1.0]])
    return np.array([-1.0, -0.5, 0.0, 0.0]), A, np.array([1.0, 1e6]), [2, 3]


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
# the forced plans' cases: (instance, rule), the clean-up pivots and the
# retire, Bland, devex with the phase change and the 1e8 reset, ties
PLAN_CASES = [("equalities", "dantzig"), ("equalities", "devex"),
              ("cleanup", "devex_maxpiv"), ("long", "bland"),
              ("long", "maxpiv"), ("long", "devex"),
              ("tiny_pivot", "devex"), ("beale", "stall_bland"),
              ("numeric", "dantzig"), ("ray", "devex")]


def port_state(instance, dtype):
    return make_state(*INSTANCES[instance](), dtype=dtype, device="cpu")


def options(rule, dtype, **kw):
    return eta_scaled_options(SolverOptions.for_dtype(
        dtype, **RULES[rule], **kw), dtype)


def as_bits(x: torch.Tensor) -> torch.Tensor:
    """Floats as their bits after ``+ 0.0`` (NaN as one value)."""
    if not x.is_floating_point():
        return x
    ints = torch.int64 if x.dtype == torch.float64 else torch.int32
    return (torch.nan_to_num(x, nan=0.5) + 0.0).view(ints)


def raw_bits(x):
    """The tensor's bits, the sign of a zero included."""
    if x.dtype == torch.float64:
        return x.view(torch.int64)
    if x.dtype == torch.float32:
        return x.view(torch.int32)
    return x


def assert_walks_equal(a, b, ga, gb):
    """Every field of two walks' states and their devex weights equal, the
    floats as ``T + 0.0`` with NaN equal."""
    for name in a._fields:
        assert torch.equal(as_bits(getattr(a, name).cpu()),
                           as_bits(getattr(b, name).cpu())), name
    assert torch.equal(as_bits(ga.cpu()), as_bits(gb.cpu()))


def card_flush(T, U, V, ca, opt_tol, piv_tol):
    """B1 on the card for a plain version's record on the CPU: ``T += U^T
    V`` in place and the scan columns, as ``block.fused_flush`` computes
    them for the launches' walks."""
    from tpulp_torch.kernels.block import fused_flush

    Tc = T.cuda()
    _, scan = fused_flush(Tc, U.cuda(), V.cuda(), ca.cuda(), opt_tol,
                          piv_tol)
    T.copy_(Tc.cpu())
    return T, scan.cpu()


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py's phase 5d runs this "
                    "file there)")


def _sms():
    return torch.cuda.get_device_properties(0).multi_processor_count


def _cuda(state):
    return type(state)(*(x.cuda() for x in state))


def _grid_held(state, opts, stall, budget, Kb, blocks=None, refs=None,
               **kw):
    """One ``blocked_grid`` walk (``kw``: resident, vectors) against
    ``blocked_grid_reference`` on the plan's grid, flushed by the same B1,
    every field (the reference kept in ``refs`` by grid and budget: it is
    the same on every plan); returns the plan."""
    plan = kg.blocked_grid_plan(*state.T.shape, Kb, state.T.dtype, _sms(),
                                blocks, **kw)
    out, g = kg.blocked_grid(_cuda(state), opts, stall, budget, Kb,
                             blocks=blocks, **kw)
    refs = {} if refs is None else refs
    if (plan.blocks, budget) not in refs:
        refs[plan.blocks, budget] = kg.blocked_grid_reference(
            state, opts, stall, budget, Kb, plan.blocks, flush=card_flush)
    ref, gr = refs[plan.blocks, budget]
    torch.cuda.synchronize()
    assert_walks_equal(out, ref, g, gr)
    return plan


# ---------------------------------------------------------------------------
# the grid
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cuda_blocked_kernels_match_the_plain_walk(dtype):
    """Every instance and rule of the plain stages' CPU tests walked on the
    grid's plan (what ``run_simplex_blocked`` runs past the cluster) to a
    budget of 500 and held to the plain-stage walk ``blocked_walk_
    reference``, flushed by the same B1, every field; and the ray launch
    held to its plain stage at the end of the first three blocks."""
    _need_card()
    tt = getattr(torch, dtype)
    for instance in INSTANCES:
        for rule in RULES:
            state = port_state(instance, tt)
            opts = options(rule, tt, max_iters=500)
            stall = opts.resolved_stall_limit(state.m, state.n)
            out, g = kg.blocked_grid(_cuda(state), opts, stall,
                                     opts.max_iters, K)
            ref, gr = kb.blocked_walk_reference(state, opts, stall,
                                                opts.max_iters, K,
                                                flush=card_flush)
            torch.cuda.synchronize()
            assert_walks_equal(out, ref, g, gr)
            _cuda_ray(kb.make_record(_cuda(state), K), opts, stall)


def _cuda_ray(rec, opts, stall):
    """The ray launch against its plain stage at the end of the first
    three blocks of plain slots."""
    from tpulp_torch.kernels.block import fused_flush

    for _ in range(3):
        for _ in range(K):
            kb.blocked_pivot_reference(rec, opts, stall, opts.max_iters)
        _, scan = fused_flush(*kb.flush_inputs(rec), float(opts.opt_tol),
                              float(opts.piv_tol))
        k, p = kb.clone_record(rec), kb.clone_record(rec)
        kb.blocked_ray(k, scan, opts, stall, opts.max_iters)
        kb.blocked_ray_reference(p, scan, opts)
        torch.cuda.synchronize()
        for (name, a), (_, b) in zip(kb.record_tensors(k),
                                     kb.record_tensors(p)):
            assert torch.equal(as_bits(a.cpu()), as_bits(b.cpu())), \
                ("ray", name)
        rec = p


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cuda_blocked_grid_matches_its_plain_version(dtype):
    """The plan's grid and forced grids of 1, 2, 3 and 7 blocks, to the
    exit and to a budget inside a block, every instance and rule."""
    _need_card()
    tt = getattr(torch, dtype)
    for instance in INSTANCES:
        for rule in RULES:
            state = port_state(instance, tt)
            opts = options(rule, tt, max_iters=500)
            stall = opts.resolved_stall_limit(state.m, state.n)
            for G in GRIDS:
                for budget in (opts.max_iters, 5):
                    plan = _grid_held(state, opts, stall, budget, K, G)
                    assert (plan.resident, plan.vectors) == (K, "shared")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cuda_device_factor_plans_match_their_plain_version(dtype):
    """The device-factor plans forced at the small frames: no slot of the
    slabs in shared memory (``resident=0``), some of them (2 of 4), and the
    running vectors, the basis and the artificial bits in device memory
    (``vectors="device"``, with every slot in shared memory and with
    none), on the plan's grid and on 1, 3 and 7 blocks, to the exit and to
    budgets inside a block (5, 6): every field equal to
    ``blocked_grid_reference`` on that grid."""
    _need_card()
    tt = getattr(torch, dtype)
    plans = ({"resident": 0}, {"resident": 2},
             {"vectors": "device"}, {"vectors": "device", "resident": 0})
    for instance, rule in PLAN_CASES:
        state = port_state(instance, tt)
        opts = options(rule, tt, max_iters=500)
        stall = opts.resolved_stall_limit(state.m, state.n)
        refs = {}
        for kw in plans:
            for G in (None, 1, 3, 7):
                for budget in (opts.max_iters, 5, 6):
                    plan = _grid_held(state, opts, stall, budget, K, G, refs,
                                      **kw)
                    assert plan.resident == kw.get("resident", K)
                    assert plan.vectors == kw.get("vectors", "shared")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cuda_device_factor_plans_on_a_longer_walk(dtype):
    """The longer instance in blocks of 8 on every forced plan (slots past
    KR written in one block and read by its next slots), each walk to its
    exit and every field held; the walks of all the plans equal."""
    _need_card()
    tt = getattr(torch, dtype)
    for rule in ("dantzig", "devex", "bland", "maxpiv"):
        state = port_state("long", tt)
        opts = options(rule, tt, max_iters=500)
        stall = opts.resolved_stall_limit(state.m, state.n)
        refs = {}
        for kw in ({}, {"resident": 0}, {"resident": 5},
                   {"vectors": "device"},
                   {"vectors": "device", "resident": 3}):
            _grid_held(state, opts, stall, opts.max_iters, 8, 3, refs, **kw)


# ---------------------------------------------------------------------------
# the cluster, solo and batched
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cuda_blocked_cluster_matches_its_plain_version(dtype):
    """Every cluster size, to the exit and to a budget inside a block,
    every instance and rule."""
    _need_card()
    tt = getattr(torch, dtype)
    for instance in INSTANCES:
        for rule in RULES:
            state = port_state(instance, tt)
            opts = options(rule, tt, max_iters=500)
            stall = opts.resolved_stall_limit(state.m, state.n)
            for C in kbc.BLOCKED_CLUSTER_SIZES:
                for budget in (opts.max_iters, 5):
                    out, g = kbc.blocked_cluster(_cuda(state), opts, stall,
                                                 budget, K, blocks=C)
                    ref, gr = kbc.blocked_cluster_reference(
                        state, opts, stall, budget, K, C, flush=card_flush)
                    torch.cuda.synchronize()
                    assert_walks_equal(out, ref, g, gr)


def _lane(seed, m=12, n=20):
    """tests/test_torch_batch.py's random instance (a sum row on every
    third seed, so some lanes are bounded and some unbounded) as the port's
    LinProg."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n))
    x0 = np.abs(rng.normal(size=n))
    b = A @ x0 + np.abs(rng.normal(size=m))
    c = rng.normal(size=n)
    if seed % 3 == 0:
        A[-1] = 1.0
        b[-1] = 2.0 * x0.sum()
    lp = LinProg()
    for j in range(n):
        lp.addVar(f"x{j}")
    lp.minimize(sum((LinExpr(float(c[j]), f"x{j}") for j in range(n)),
                    LinExpr()))
    for i in range(m):
        e = sum((LinExpr(float(A[i, j]), f"x{j}") for j in range(n)),
                LinExpr())
        lp.addConstraint(e.constraintLeq(float(b[i])))
    return lp


# (rule, K, budget, C): tests/test_torch_blocked_batch_kernel.py's CASES
BATCH_CASES = [("dantzig", 4, 2000, 1), ("dantzig", 8, 7, 2),
               ("devex", 4, 7, 4), ("devex", 8, 2000, 8),
               ("bland", 4, 2000, 2), ("bland", 8, 7, 4),
               ("devex", 4, 2000, 1), ("bland", 8, 2000, 8)]
BATCH_RULES = {"dantzig": 0, "devex": RULE_DEVEX, "bland": RULE_BLAND}


def _frozen_start(budget, dtype):
    """Seven lanes with every zero of lanes 1, 2 and 3 made -0.0; lane 1
    already ended (OPTIMAL), lane 2 running at its budget, lane 3 running
    five pivots short of it."""
    sfs = [_lane(s).lower() for s in range(6)] + [_lane(6, m=8, n=15).lower()]
    start = make_batched_states(sfs, device="cpu", dtype=dtype)
    T = start.T.clone()
    for k in (1, 2, 3):
        T[k][T[k] == 0] = -0.0
    status, niter = start.status.clone(), start.niter.clone()
    status[1] = Status.OPTIMAL
    niter[2], niter[3] = budget, budget - 5
    return start._replace(T=T, status=status, niter=niter)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cuda_cluster_batch_matches_its_plain_version(dtype):
    """``blocked_cluster_batch`` on the seven lanes (an ended lane, one at
    its budget, one frozen inside the walk) against its plain version,
    every field bit for bit (the sign of a zero included)."""
    _need_card()
    tt = getattr(torch, dtype)
    for rule, Kb, budget, C in BATCH_CASES:
        start = _frozen_start(budget, tt)
        opts = eta_scaled_options(SolverOptions.for_dtype(
            tt, rule=BATCH_RULES[rule], max_iters=budget), tt)
        stall = opts.resolved_stall_limit(start.T.shape[1] - 2,
                                          start.T.shape[2] - 1)
        out, g = kbc.blocked_cluster_batch(_cuda(start), opts, stall,
                                           budget, Kb, blocks=C)
        ref, gr = kbc.blocked_cluster_batch_reference(
            start, opts, stall, budget, Kb, C, flush=card_flush)
        torch.cuda.synchronize()
        for name in out._fields:
            assert torch.equal(raw_bits(getattr(out, name).cpu()),
                               raw_bits(getattr(ref, name).cpu())), name
        assert torch.equal(raw_bits(g.cpu()), raw_bits(gr.cpu()))

"""The blocked batch on the card (``tpulp_torch/kernels/blocked_cluster.py``'s
``blocked_cluster_batch``: one cluster launch a block for every lane, B1
and the ray launch with a lane axis), held on the CPU through its plain
version ``blocked_cluster_batch_reference``: on TestBlockedBatch's seven
lanes (six of 12 x 20, one of 8 x 15 padded to them) it ends where tpulp's
vmapped ``run_simplex_blocked_batch`` does (status, pivots, basis, phase
and artificial columns exactly, the tableaus within 1e-9: the eager batch
sums its eta products in the library's order, the plain version one fma a
slot in slot order) under Dantzig, devex and Bland, blocks of 4 and 8,
budgets of 2000 and 7 and clusters of 1, 2, 4 and 8; each of its lanes
equals the solo ``blocked_cluster_reference`` of its padded lane in every
field bit for bit; a lane frozen at a block's start (ended, or running at
its budget) comes out bit for bit, -0.0 entries included, and so does a
frozen lane of B1's batched plain version. The batched record's layout, the
launch's int arguments, the wrappers' refusals and
``run_simplex_blocked_batch``'s dispatch are held here too. The kernels
run on the card only (the ``cuda`` test; chip_smoke.py's phase 8c holds
them at full size)."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpulp_torch
import tpulp_torch.kernels.blocked as kb
import tpulp_torch.kernels.blocked_cluster as kbc
from tpulp.batch import make_batched_states as tpulp_make_batched
from tpulp.core.state import SolverOptions as TpulpOptions
from tpulp.solve.blocked import run_simplex_blocked_batch as tpulp_batch
from tpulp_torch.batch import make_batched_states, unstack_state
from tpulp_torch.core import SolverOptions, Status
from tpulp_torch.core.state import RULE_BLAND, RULE_DEVEX, eta_scaled_options
from tpulp_torch.kernels import LAUNCHES, reset_launches
from tpulp_torch.kernels.block import (fused_flush_batch,
                                       fused_flush_batch_reference,
                                       fused_flush_reference)
from tpulp_torch.solve import blocked as pb

from test_torch_batch import _lane
from test_torch_model import to_port

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RULE = {"dantzig": 0, "devex": RULE_DEVEX, "bland": RULE_BLAND}
# (rule, K, budget, C): every rule with blocks of 4 and 8, budgets of 2000
# (lanes end in different blocks) and 7 (inside a block) and clusters of
# 1, 2, 4 and 8, each case one tpulp run
CASES = [("dantzig", 4, 2000, 1), ("dantzig", 8, 7, 2),
         ("devex", 4, 7, 4), ("devex", 8, 2000, 8),
         ("bland", 4, 2000, 2), ("bland", 8, 7, 4),
         ("devex", 4, 2000, 1), ("bland", 8, 2000, 8)]
IDS = [f"{r}-K{k}-budget{b}-C{c}" for r, k, b, c in CASES]


def _sfs():
    return [_lane(s).lower() for s in range(6)] + [
        _lane(6, m=8, n=15).lower()]


def _batch(dtype=torch.float64):
    return make_batched_states(to_port(_sfs()), device="cpu", dtype=dtype)


def _options(rule, budget, dtype=torch.float64):
    return eta_scaled_options(SolverOptions.for_dtype(
        dtype, rule=RULE[rule], max_iters=budget), dtype)


def _stall(opts, batched):
    return opts.resolved_stall_limit(batched.T.shape[1] - 2,
                                     batched.T.shape[2] - 1)


_RUNS = {}


def plain_batch(case):
    """(start, opts, plain batch's (state, weights)) of a case, once."""
    if case not in _RUNS:
        rule, K, budget, C = case
        start = _batch()
        opts = _options(rule, budget)
        _RUNS[case] = (start, opts, kbc.blocked_cluster_batch_reference(
            start, opts, _stall(opts, start), budget, K, C))
    return _RUNS[case]


def raw_bits(x):
    """The tensor's bits, the sign of a zero included."""
    if x.dtype == torch.float64:
        return x.view(torch.int64)
    if x.dtype == torch.float32:
        return x.view(torch.int32)
    return x


# ---------------------------------------------------------------------------
# against tpulp, the eager batch and the solo walks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_batch_matches_tpulp(case):
    """The plain batch against tpulp's vmapped blocked batch (jitted on the
    CPU, as TestBlockedBatch runs it) and the port's eager batch: status,
    pivots, basis, phase and artificial columns exactly, T within 1e-9."""
    rule, K, budget, C = case
    start, opts, (out, _) = plain_batch(case)
    out = pb.finish(out)
    ref = tpulp_batch(tpulp_make_batched(_sfs(), dtype=jnp.float64),
                      TpulpOptions.for_dtype(jnp.float64, rule=RULE[rule],
                                             max_iters=budget), block=K)
    eager = pb.run_simplex_blocked_batch_reference(start, opts, K)
    for name in ("status", "niter", "basis", "phase", "art_cols"):
        assert np.array_equal(getattr(out, name).numpy(),
                              np.asarray(getattr(ref, name))), name
        assert torch.equal(getattr(out, name), getattr(eager, name)), name
    np.testing.assert_allclose(out.T.numpy(), np.asarray(ref.T), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(out.T.numpy(), eager.T.numpy(), rtol=1e-9,
                               atol=1e-9)
    if budget == 2000:
        assert len(set(out.niter.tolist())) > 1
        assert {Status.OPTIMAL, Status.UNBOUNDED} <= set(out.status.tolist())
    else:
        assert set(out.niter.tolist()) == {budget}


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_batch_lanes_equal_their_solo_walks(case):
    """Each lane of the plain batch against the solo
    ``blocked_cluster_reference`` of its padded lane: every field and the
    devex weights bit for bit (NaN and the sign of a zero included)."""
    rule, K, budget, C = case
    start, opts, (out, gamma) = plain_batch(case)
    stall = _stall(opts, start)
    for k in range(start.T.shape[0]):
        solo, g = kbc.blocked_cluster_reference(unstack_state(start, k), opts,
                                                stall, budget, K, C)
        for name in solo._fields:
            a, b = getattr(solo, name), getattr(out, name)[k]
            assert torch.equal(raw_bits(a), raw_bits(b)), (k, name)
        assert torch.equal(raw_bits(g), raw_bits(gamma[k])), (k, "gamma")


def test_plain_batch_never_writes_the_callers_state():
    start = _batch()
    before = [x.clone() for x in start]
    opts = _options("devex", 2000)
    kbc.blocked_cluster_batch_reference(start, opts, _stall(opts, start),
                                        2000, 4, 2)
    for x, y in zip(start, before):
        assert torch.equal(raw_bits(x), raw_bits(y))


# ---------------------------------------------------------------------------
# the block-start freeze
# ---------------------------------------------------------------------------

def _frozen_start(budget, dtype=torch.float64):
    """The seven lanes with every zero of lanes 1, 2 and 3 made -0.0; lane
    1 already ended (OPTIMAL), lane 2 running at its budget, lane 3 running
    five pivots short of it (frozen after its second block of 4)."""
    start = _batch(dtype)
    T = start.T.clone()
    for k in (1, 2, 3):
        T[k][T[k] == 0] = -0.0
    status, niter = start.status.clone(), start.niter.clone()
    status[1] = Status.OPTIMAL
    niter[2], niter[3] = budget, budget - 5
    return start._replace(T=T, status=status, niter=niter)


@pytest.mark.parametrize("rule", ["dantzig", "devex"])
def test_frozen_lanes_keep_their_state_bit_for_bit(rule):
    """An ended lane and a running lane at its budget come out as they went
    in, bit for bit (-0.0 included: no flush of zero factors touched
    them), with their weights ones; the lane frozen after two blocks equals
    its solo walk; every lane equals the eager batch in its integers."""
    budget = 60
    start = _frozen_start(budget)
    opts = _options(rule, budget)
    stall = _stall(opts, start)
    out, gamma = kbc.blocked_cluster_batch_reference(start, opts, stall,
                                                     budget, 4, 2)
    assert int(out.niter[0]) // 4 > 2  # the others walk on past lane 3
    for k in (1, 2):
        for name in out._fields:
            assert torch.equal(raw_bits(getattr(out, name)[k]),
                               raw_bits(getattr(start, name)[k])), (k, name)
        assert torch.equal(gamma[k], torch.ones_like(gamma[k]))
    assert bool((raw_bits(out.T[1]) == raw_bits(torch.tensor(-0.0,
                 dtype=torch.float64))).any())
    assert int(out.niter[3]) == budget
    solo, g = kbc.blocked_cluster_reference(unstack_state(start, 3), opts,
                                            stall, budget, 4, 2)
    for name in solo._fields:
        assert torch.equal(raw_bits(getattr(solo, name)),
                           raw_bits(getattr(out, name)[3])), name
    assert torch.equal(raw_bits(g), raw_bits(gamma[3]))
    eager = pb.run_simplex_blocked_batch_reference(start, opts, 4)
    done = pb.finish(out)
    for name in ("status", "niter", "basis", "phase", "art_cols", "stuck",
                 "bland"):
        assert torch.equal(getattr(done, name), getattr(eager, name)), name
    for k in (1, 2):
        assert torch.equal(raw_bits(eager.T[k]), raw_bits(start.T[k]))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_flush_batch_reference_skips_frozen_lanes(dtype):
    """B1's batched plain version: a lane whose flag is 0 keeps its T bit
    for bit (-0.0 entries and nonzero factors included) and zero scan
    columns; a live lane equals the solo plain flush of that lane bit for
    bit. On CPU tensors ``fused_flush_batch`` is the plain version."""
    rng = np.random.default_rng(3)
    B, M, N, K = 4, 7, 11, 3
    T0 = torch.tensor(rng.standard_normal((B, M, N)), dtype=dtype)
    T0[T0.abs() < 0.4] = -0.0
    U = torch.tensor(rng.standard_normal((B, K, M)), dtype=dtype)
    V = torch.tensor(rng.standard_normal((B, K, N)), dtype=dtype)
    ca = torch.tensor(rng.integers(0, 2, (B, N)), dtype=torch.int32)
    ca[:, -1] = 0
    ints = torch.zeros((B, kb.NI + 1), dtype=torch.int32)
    ints[:, kb.LIVE] = torch.tensor([1, 0, 1, 0], dtype=torch.int32)
    live = ints[:, kb.LIVE]
    assert live.stride(0) == kb.NI + 1
    for flush in (fused_flush_batch_reference, fused_flush_batch):
        T = T0.clone()
        out, scan = flush(T, U, V, ca, live, 0.5, 0.25)
        assert out is T and tuple(scan.shape) == (B, 2, N)
        for k in range(B):
            if k in (1, 3):
                assert torch.equal(raw_bits(T[k]), raw_bits(T0[k]))
                assert not bool(scan[k].any())
            else:
                want, wscan = fused_flush_reference(T0[k].clone(), U[k],
                                                    V[k], ca[k], 0.5, 0.25)
                assert torch.equal(raw_bits(T[k]), raw_bits(want))
                assert torch.equal(scan[k], wscan)


def test_plain_block_of_a_frozen_record_only_records_the_verdict():
    """``blocked_cluster_block_reference`` on a record running at its
    budget (a slot would still record an exit there) and on an ended one:
    every field as it was but ``LIVE = 0``; a live record gets ``LIVE =
    1``."""
    state = unstack_state(_batch(), 0)
    opts = _options("dantzig", 5)
    stall = opts.resolved_stall_limit(state.m, state.n)
    for edit in ({"niter": torch.tensor(5, dtype=torch.int32)},
                 {"status": torch.tensor(Status.OPTIMAL,
                                         dtype=torch.int32)}):
        rec = kb.make_record(state._replace(**edit), 4)
        before = kb.clone_record(rec)
        kbc.blocked_cluster_block_reference(rec, opts, stall, 5, 2)
        assert int(rec.ints[kb.LIVE]) == 0
        rec.ints[kb.LIVE] = 1
        for name, a, b in zip(rec._fields, rec, before):
            assert torch.equal(raw_bits(a), raw_bits(b)), name
    rec = kb.make_record(state, 4)
    rec.ints[kb.LIVE] = 0
    kbc.blocked_cluster_block_reference(rec, opts, stall, 5, 2)
    assert int(rec.ints[kb.LIVE]) == 1 and int(rec.ints[kb.NITER]) == 4


# ---------------------------------------------------------------------------
# the batched record and the launch's arguments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_batch_record_is_the_lanes_records_stacked(dtype):
    """``make_batch_record``: every field contiguous with a leading lane
    axis and, lane by lane, ``make_record`` of that lane bit for bit (LIVE
    set); ``lane_record`` views it; ``record_state`` gives the batch back."""
    start = _frozen_start(60, dtype)
    rec = kb.make_batch_record(start, 8)
    B = start.T.shape[0]
    for name, x in kb.record_tensors(rec):
        assert x.is_contiguous() and x.shape[0] == B, name
    assert tuple(rec.ints.shape) == (B, kb.NI + 1)
    assert bool((rec.ints[:, kb.LIVE] == 1).all())
    for k in range(B):
        solo = kb.make_record(unstack_state(start, k), 8)
        lane = kb.lane_record(rec, k)
        for name, a, b in zip(rec._fields, lane, solo):
            assert torch.equal(raw_bits(a), raw_bits(b)), (k, name)
        assert lane.T.data_ptr() == rec.T[k].data_ptr()
    back = kb.record_state(rec)
    for name in back._fields:
        assert torch.equal(raw_bits(getattr(back, name)),
                           raw_bits(getattr(start, name))), name


def test_launch_int_arguments():
    """The cluster launch's int arguments (csrc/blocked_cluster.cu's Int):
    the shape, the plan, the lanes and the record's per-lane extents, which
    ``make_batch_record`` gives its ``ints`` and ``vals``."""
    plan = kbc.blocked_cluster_plan(514, 1537, 64, torch.float64)
    ints = list(kbc._plan_ints(plan, 514, 1537, 64, 8))
    assert ints == [514, 1537, 64, 0, 0, 0, 0, 8, 512, 144_176, 8,
                    kb.NI + 6, kb.NV]
    assert kb.NI == kb.LIVE + 1 and kb.LIVE == kb.RAY + 1
    assert list(kbc._plan_ints(plan, 514, 1537, 64))[10] == 1
    rec = kb.make_batch_record(_batch(), 8)
    B, M, N = rec.T.shape
    ints = list(kbc._plan_ints(kbc.blocked_cluster_plan(M, N, 8,
                                                        torch.float64, 2),
                               M, N, 8, B))
    assert ints[10:] == [B, rec.ints.stride(0), rec.vals.stride(0)]


def test_walk_batch_reads_once_a_block_until_no_lane_runs():
    """``_walk_batch`` calls the block while any lane runs within the
    budget: as many times as the longest lane's solo walk has blocks."""
    start = _batch()
    opts = _options("dantzig", 2000)
    stall = _stall(opts, start)

    def block(rec):
        kbc.blocked_cluster_block_reference(rec, opts, stall, 2000, 1)
        if int(rec.ints[kb.LIVE]):
            _, scan = fused_flush_reference(*kb.flush_inputs(rec),
                                            float(opts.opt_tol),
                                            float(opts.piv_tol))
            kb.blocked_ray_reference(rec, scan, opts)

    batch = kb.make_batch_record(start, 4)
    calls = []

    def batch_block(rec):
        calls.append(rec.ints[:, kb.NITER].tolist())
        for k in range(rec.T.shape[0]):
            block(kb.lane_record(rec, k))

    kb._walk_batch(batch, 2000, batch_block)
    blocks = []
    for k in range(start.T.shape[0]):
        n = []
        kb._walk(kb.make_record(unstack_state(start, k), 4), 2000,
                 lambda rec: (n.append(1), block(rec)))
        blocks.append(len(n))
    assert len(calls) == max(blocks) and len(set(blocks)) > 1


# ---------------------------------------------------------------------------
# the dispatch
# ---------------------------------------------------------------------------

def test_cpu_batch_runs_the_eager_loop(monkeypatch):
    """On CPU tensors ``run_simplex_blocked_batch`` is the eager vmapped
    loop, bit for bit, with no route asked and no launch counted; so is
    ``solve_lp_batch(driver="blocked")``."""
    def refuse(*args, **kw):
        raise AssertionError("a kernel route was taken on the CPU")

    for name in ("blocked_cluster_batch", "blocked_steps", "blocked_route",
                 "blocked_cluster_occupancy"):
        monkeypatch.setattr(pb, name, refuse)
    monkeypatch.setattr(kbc, "blocked_cluster_batch", refuse)
    reset_launches()
    start = _batch()
    for rule in ("dantzig", "devex"):
        opts = _options(rule, 2000)
        out = pb.run_simplex_blocked_batch(start, opts, block=4)
        ref = pb.run_simplex_blocked_batch_reference(start, opts, block=4)
        for name in out._fields:
            assert torch.equal(raw_bits(getattr(out, name)),
                               raw_bits(getattr(ref, name))), name
    sols = tpulp_torch.solve_lp_batch(to_port(_sfs()[:2]), driver="blocked",
                                      block=4, device="cpu")
    # lane 0 carries a sum row: bounded; lane 1 does not
    assert [s.status for s in sols] == ["optimal", "unbounded"]
    assert all(v == 0 for v in LAUNCHES.values())


def test_cuda_dispatch_takes_the_route_with_no_fallback(monkeypatch):
    """``run_simplex_blocked_batch`` on a batch it must treat as on the card
    (``on_cpu`` and the occupancy patched): the cluster batch gets a
    contiguous tableau, the stall limit, the budget and the block; the
    eager loop and ``blocked_steps`` never run; its failure raises. With
    occupancy 0 (no cluster and no grid) each lane's solo walk runs on
    ``blocked_steps`` in turn, stacked in lane order."""
    def refuse(*args, **kw):
        raise AssertionError("another route ran")

    seen = []

    def cluster_spy(batched, opts, stall_limit, max_iters, block):
        seen.append(("cluster", batched.T.is_contiguous(), stall_limit,
                     max_iters, block))
        return batched, None

    def steps_spy(state, opts, stall_limit, max_iters, block):
        seen.append(("steps", state.T.shape, stall_limit, max_iters, block))
        return state._replace(niter=state.niter + len(seen)), None

    occ = [15]
    monkeypatch.setattr(pb, "on_cpu", lambda *t: False)
    monkeypatch.setattr(pb, "blocked_cluster_occupancy", lambda *a: occ[0])
    monkeypatch.setattr(pb, "blocked_grid_occupancy", lambda *a: occ[0])
    monkeypatch.setattr(pb, "sm_count", lambda device: 132)
    monkeypatch.setattr(pb, "blocked_grid", refuse)
    monkeypatch.setattr(pb, "run_simplex_blocked_batch_reference", refuse)
    monkeypatch.setattr(pb, "_blocked_pivot", refuse)
    monkeypatch.setattr(pb, "blocked_steps", refuse)
    monkeypatch.setattr(pb, "blocked_cluster_batch", cluster_spy)
    start = _batch()
    strided = start._replace(T=start.T.transpose(1, 2).contiguous()
                             .transpose(1, 2))
    assert not strided.T.is_contiguous()
    m, n = start.T.shape[1] - 2, start.T.shape[2] - 1
    out = pb.run_simplex_blocked_batch(strided, _options("dantzig", 77),
                                       block=16)
    assert seen == [("cluster", True, m + n, 77, 16)]
    assert set(out.status.tolist()) == {Status.ITERATION_LIMIT}

    def fail(*args, **kw):
        raise RuntimeError("tpulp_torch blocked_cluster_batch: CUDA error 1")

    monkeypatch.setattr(pb, "blocked_cluster_batch", fail)
    with pytest.raises(RuntimeError, match="blocked_cluster_batch"):
        pb.run_simplex_blocked_batch(start)
    occ[0] = 0
    seen.clear()
    monkeypatch.setattr(pb, "blocked_cluster_batch", refuse)
    monkeypatch.setattr(pb, "blocked_steps", steps_spy)
    out = pb.run_simplex_blocked_batch(start, _options("dantzig", 77),
                                       block=16)
    B = start.T.shape[0]
    assert seen == [("steps", start.T.shape[1:], m + n, 77, 16)] * B
    assert out.niter.tolist() == list(range(1, B + 1))


# ---------------------------------------------------------------------------
# the wrappers' refusals
# ---------------------------------------------------------------------------

def _refused(batched, K=8, match="CUDA", kind=ValueError):
    opts = _options("dantzig", 10)
    with pytest.raises(kind, match=match):
        kbc.blocked_cluster_batch(batched, opts, 10, 10, K)


def test_cluster_batch_refuses_what_it_cannot_run():
    """CPU tensors, mixed devices, a strided tableau, a field of another
    type, float16, a K past ``MAX_K``, a solo state: refused before any
    launch."""
    start = _batch()
    reset_launches()
    _refused(start)
    _refused(start._replace(basis=start.basis.to("meta")))
    strided = start._replace(T=start.T.transpose(1, 2).contiguous()
                             .transpose(1, 2))
    _refused(strided, match="contiguous")
    _refused(start._replace(last_z=start.last_z.float()), match="last_z")
    _refused(start._replace(T=start.T.half(), last_z=start.last_z.half()),
             match="float32 or float64")
    _refused(start, K=kb.MAX_K + 1, match="outside")
    _refused(unstack_state(start, 0), match="contiguous")
    assert all(v == 0 for v in LAUNCHES.values())


def test_batch_launches_refuse_cpu_and_solo_records():
    """The cluster batch launch, the ray launch over the lanes and B1's
    batched launch refuse a record on the CPU, a solo record or a mixed
    batch; nothing is counted."""
    start = _batch()
    opts = _options("dantzig", 10)
    rec = kb.make_batch_record(start, 4)
    solo = kb.make_record(unstack_state(start, 0), 4)
    reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        kbc.blocked_cluster_batch_block(rec, opts, 10, 10)
    with pytest.raises(ValueError, match="batched"):
        kb.ray_batch(solo, torch.zeros((2, 2), dtype=torch.int32), opts, 10,
                     10)
    scan = torch.zeros((rec.T.shape[0], 2, rec.T.shape[2]),
                       dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kb.ray_batch(rec, scan, opts, 10, 10)
    with pytest.raises(ValueError, match="CPU or on one CUDA"):
        fused_flush_batch(rec.T, rec.U, rec.V, rec.ca.to("meta"),
                          rec.ints[:, kb.LIVE], 0.5, 0.25)
    assert all(v == 0 for v in LAUNCHES.values())


def test_no_jax_or_tpulp_on_the_batch_path():
    """The batch's modules and its plain version run without loading jax
    or any module of tpulp."""
    code = """
import sys
import torch
from tpulp_torch.batch import make_batched_states
import tpulp_torch.kernels.blocked_cluster as kbc
import tpulp_torch.kernels.block as kblock
import tpulp_torch.solve.blocked as pb
from tpulp_torch import LinExpr, LinProg
from tpulp_torch.core import SolverOptions
lps = []
for rhs in (12, 10):
    p = LinProg()
    p.addVar("x")
    p.addVar("y")
    p.maximize(LinExpr(40, "x", 30, "y"))
    p.addConstraint(LinExpr(1, "x", 1, "y").constraintLeq(rhs))
    p.addConstraint(LinExpr(2, "x", 1, "y").constraintLeq(16))
    lps.append(p.lower())
st = make_batched_states(lps, device="cpu")
opts = SolverOptions.for_dtype(torch.float64)
out, _ = kbc.blocked_cluster_batch_reference(st, opts, 10, 100, 4, 2)
assert out.status.tolist() == [1, 1], out.status
assert pb.run_simplex_blocked_batch(st, opts, 4).niter.tolist() == \\
    out.niter.tolist()
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "tpulp" or m.startswith("tpulp."))
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout


# ---------------------------------------------------------------------------
# on a card only: the kernels against their plain versions
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cuda_cluster_batch_matches_its_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py's phase 8c runs these "
                    "checks at full size)")
    from tpulp_torch.kernels.block import fused_flush

    tt = getattr(torch, dtype)
    for rule, K, budget, C in CASES:
        start = _frozen_start(budget, tt)
        start = type(start)(*(x.cuda() for x in start))
        opts = _options(rule, budget, tt)
        stall = _stall(opts, start)
        out, g = kbc.blocked_cluster_batch(start, opts, stall, budget, K,
                                           blocks=C)
        ref, gr = kbc.blocked_cluster_batch_reference(
            start, opts, stall, budget, K, C, flush=fused_flush)
        torch.cuda.synchronize()
        for name in out._fields:
            assert torch.equal(raw_bits(getattr(out, name).cpu()),
                               raw_bits(getattr(ref, name).cpu())), name
        assert torch.equal(raw_bits(g.cpu()), raw_bits(gr.cpu()))

"""tpulp_torch's kernel engine against tpulp's Pallas kernels (interpret
mode): the plain versions of the two kernels, the block driver around them,
the launch counters, the nvcc command line, and (on a card only) the CUDA
kernels against their plain versions."""

import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulp import LinExpr, LinProg
from tpulp.core import make_state as tpulp_make_state
from tpulp.core.state import RULE_BLAND, RULE_DANTZIG, RULE_DEVEX
from tpulp.core.state import SolverOptions as TpulpOptions
from tpulp.kernels.pallas_block import blocked_inner_block as tpulp_block
from tpulp.kernels.pallas_block import fused_flush as tpulp_flush
from tpulp.solve.blocked_pallas import run_simplex_blocked_pallas
from chip_smoke import FLUSH_SHAPES, flush_inputs, scan_case
from tpulp_torch.core import (SolverOptions, Status, eta_scaled_options,
                              from_numpy_state)
from tpulp_torch.kernels import (LAUNCHES, blocked_inner_block,
                                 blocked_inner_block_reference, fused_flush,
                                 fused_flush_reference, reset_launches)
from tpulp_torch.kernels import build
from tpulp_torch.solve import run_simplex_blocked_kernel
from tpulp_torch.solve.blocked_kernel import kernel_inputs

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
BIG_I = 2 ** 30


def _random(seed, m=12, n=20, bounded=False):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n))
    x0 = np.abs(rng.normal(size=n))
    b = A @ x0 + np.abs(rng.normal(size=m))
    c = rng.normal(size=n)
    if bounded:
        A[-1] = 1.0
        b[-1] = 2.0 * x0.sum()
    return (np.concatenate([c, np.zeros(m)]),
            np.concatenate([A, np.eye(m)], axis=1), b,
            list(range(n, n + m)))


def _lowered(lp):
    sf = lp.lower()
    c, A, b = sf.to_dense(np.float64)
    return c, A, b, sf.basis_hint


def _cleanup():
    lp = LinProg()
    lp.addVar("x")
    lp.addVar("y")
    lp.minimize(LinExpr(2, "x", 3, "y"))
    lp.addConstraint(LinExpr(1, "x", 1, "y").constraintGeq(4))
    lp.addConstraint(LinExpr(1, "x", -1, "y").constraintEq(0))
    lp.addConstraint(LinExpr(2, "x", 2, "y").constraintGeq(8))
    return _lowered(lp)


def _beale():
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


def _unbounded():
    lp = LinProg()
    lp.addVar("x")
    lp.minimize(LinExpr(-1, "x"))
    lp.addConstraint(LinExpr(1, "x").constraintGeq(1))
    return _lowered(lp)


def _infeasible():
    lp = LinProg()
    lp.addVar("x")
    lp.minimize(LinExpr(1, "x"))
    lp.addConstraint(LinExpr(1, "x").constraintLeq(1))
    lp.addConstraint(LinExpr(1, "x").constraintGeq(3))
    return _lowered(lp)


def _eq24():
    from tpulp.corpus import get_case

    return _lowered(get_case("equality_heavy_24").lp())


def _states(inst, dtype="float64"):
    c, A, b, hint = inst
    js = tpulp_make_state(c, A, b, hint, dtype=getattr(jnp, dtype))
    ts = from_numpy_state([np.asarray(x) for x in js], device="cpu")
    return js, ts


def _opts(rule, dtype="float64", **kw):
    j = dataclasses.replace(
        TpulpOptions.for_dtype(getattr(jnp, dtype), **kw), rule=rule)
    t = dataclasses.replace(
        SolverOptions.for_dtype(getattr(torch, dtype), **kw), rule=rule)
    return j, t


# ---------------------------------------------------------------------------
# B1: the flush
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("float64", 1e-12)])
def test_flush_reference_matches_pallas(dtype, atol):
    rng = np.random.default_rng(9)
    M, N, K = 128, 256, 16
    T = rng.normal(size=(M, N))
    U = rng.normal(size=(K, M)) * 0.1
    V = rng.normal(size=(K, N)) * 0.1
    ca = rng.integers(0, 2, size=(N,))
    opt_tol = piv_tol = 1e-5
    jt = getattr(jnp, dtype)
    Tn_j, _, scan_j = tpulp_flush(
        jnp.asarray(T, jt), jnp.asarray(U, jt), jnp.asarray(V, jt),
        jnp.asarray(ca[None, :], jnp.int32), opt_tol=opt_tol,
        piv_tol=piv_tol, interpret=True)
    tt = getattr(torch, dtype)
    Tt = torch.tensor(T, dtype=tt)
    Tn_t, scan_t = fused_flush_reference(
        Tt, torch.tensor(U, dtype=tt), torch.tensor(V, dtype=tt),
        torch.tensor(ca, dtype=torch.int32), opt_tol, piv_tol)
    assert Tn_t is Tt  # in place
    np.testing.assert_allclose(Tn_t.numpy(), np.asarray(Tn_j), rtol=0,
                               atol=atol)
    assert np.array_equal(scan_t.numpy(), np.asarray(scan_j))


def _numpy_scan(Tn, ca, opt_tol, piv_tol):
    return np.stack([(ca > 0) & (Tn[0] < -opt_tol),
                     (Tn[2:] > piv_tol).any(axis=0)]).astype(np.int32)


def _numpy_flush(T, U, V, ca, opt_tol, piv_tol):
    Tn = T + U.T @ V
    return Tn, _numpy_scan(Tn, ca, opt_tol, piv_tol)


# chip_smoke.py's ragged flush shapes that fit a CPU test (the bench shape,
# 4098 x 8193 x 256, runs on the card only)
@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5),
                                        ("float64", 1e-12)])
@pytest.mark.parametrize("shape", FLUSH_SHAPES[:4],
                         ids=[f"{M}x{N}x{K}" for M, N, K in FLUSH_SHAPES[:4]])
def test_flush_reference_ragged_shapes(shape, dtype, rtol):
    """The plain flush on every ragged shape against numpy in float64:
    Tn within the dtype's tolerance relative to |T| + |U|^T|V|, and its
    scan equal to the scan of its own Tn."""
    M, N, K = shape
    T, U, V, ca = flush_inputs(M, N, K, seed=M + N + K)
    tt = getattr(torch, dtype)
    Tn, scan = fused_flush_reference(
        torch.tensor(T, dtype=tt), torch.tensor(U, dtype=tt),
        torch.tensor(V, dtype=tt), torch.tensor(ca), 1e-5, 1e-5)
    ref, _ = _numpy_flush(T, U, V, ca, 1e-5, 1e-5)
    mag = np.abs(T) + np.abs(U).T @ np.abs(V)
    assert Tn.shape == (M, N) and scan.shape == (2, N)
    assert (np.abs(Tn.double().numpy() - ref) <= rtol * mag).all()
    assert np.array_equal(scan.numpy(),
                          _numpy_scan(Tn.double().numpy(), ca, 1e-5, 1e-5))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("M,N,K", [(67, 300, 17), (8, 5, 3), (128, 256, 17)])
def test_flush_reference_scan_case(M, N, K, dtype):
    """chip_smoke.py's scan case (row 0 straddling -tol, ca = 0 at
    improving columns, rows 0 and 1 above tol, entries at and just above
    tol, lone positives in the last row and column): Tn exact and the scan
    equal to numpy's, bit for bit."""
    T, U, V, ca, tol, Tn_np, scan_np = scan_case(M, N, K)
    Tn_ref, scan_ref = _numpy_flush(T, U, V, ca, tol, tol)
    assert np.array_equal(Tn_ref, Tn_np) and np.array_equal(scan_ref, scan_np)
    tt = getattr(torch, dtype)
    Tn, scan = fused_flush_reference(
        torch.tensor(T, dtype=tt), torch.tensor(U, dtype=tt),
        torch.tensor(V, dtype=tt), torch.tensor(ca), tol, tol)
    assert np.array_equal(Tn.double().numpy(), Tn_np)
    assert np.array_equal(scan.numpy(), scan_np)
    if M % 128 == 0 and N % 128 == 0:
        jt = getattr(jnp, dtype)
        Tn_j, _, scan_j = tpulp_flush(
            jnp.asarray(T, jt), jnp.asarray(U, jt), jnp.asarray(V, jt),
            jnp.asarray(ca[None, :], jnp.int32), opt_tol=tol, piv_tol=tol,
            interpret=True)
        assert np.array_equal(np.asarray(Tn_j, np.float64), Tn_np)
        assert np.array_equal(np.asarray(scan_j), scan_np)


# ---------------------------------------------------------------------------
# B2: one block of pivots
# ---------------------------------------------------------------------------

def _pad128(x):
    return -(-x // 128) * 128


def _tpulp_block(js, jopts, K):
    """tpulp's Pallas inner block (interpret mode) from a tpulp state, with
    the padded inputs its driver builds."""
    M, N = js.T.shape
    m = M - 2
    M8, N8 = _pad128(M), _pad128(N)
    T = jnp.zeros((M8, N8), js.T.dtype).at[:M, :N].set(js.T)
    ca = jnp.zeros((1, N8), jnp.int32).at[0, :N - 1].set(
        js.col_active.astype(jnp.int32))
    ac = jnp.zeros((1, N8), jnp.int32).at[0, :N - 1].set(
        js.art_cols.astype(jnp.int32))
    basis = jnp.full((1, M8 - 2), BIG_I, jnp.int32).at[0, :m].set(js.basis)
    ab = jnp.zeros((1, M8 - 2), jnp.int32).at[0, :m].set(
        js.art_cols[js.basis].astype(jnp.int32))
    zero = jnp.zeros((), jnp.int32)
    iscal = jnp.stack([js.phase, js.status, js.niter, js.stuck,
                       js.bland.astype(jnp.int32), zero, zero, zero])
    fscal = jnp.stack([js.last_z, jnp.zeros((), js.T.dtype)])
    stall = jopts.resolved_stall_limit(js.m, js.n)
    out = tpulp_block(T, T.T, T[0:1, :], T[1:2, :],
                      T[:, N - 1].reshape(1, M8), ca, ac, basis, ab,
                      jnp.ones((1, N8), js.T.dtype), iscal, fscal,
                      opts=jopts, stall_limit=stall, K=K, n_real=N,
                      m_real=m, interpret=True)
    U, V, row0, row1, bvec, ca, ac, basis, ab, gamma, iscal, fscal = out
    return [np.asarray(x) for x in (
        U[:, :M], V[:, :N], row0[0, :N], row1[0, :N], bvec[0, :M],
        ca[0, :N], ac[0, :N], basis[0, :m], ab[0, :m], gamma[0, :N], iscal,
        fscal)]


BLOCK_STATES = {
    "bounded0": lambda: _random(0, bounded=True),
    "bounded1": lambda: _random(1, bounded=True),
    "random3": lambda: _random(3),
    "cleanup": _cleanup,
    "beale": _beale,
}


@pytest.mark.parametrize("rule", [RULE_DANTZIG, RULE_BLAND, RULE_DEVEX],
                         ids=["dantzig", "bland", "devex"])
@pytest.mark.parametrize("state", list(BLOCK_STATES))
def test_inner_block_reference_matches_pallas(state, rule):
    js, ts = _states(BLOCK_STATES[state]())
    jopts, topts = _opts(rule)
    K = 8
    ref = _tpulp_block(js, jopts, K)
    stall = topts.resolved_stall_limit(ts.m, ts.n)
    out = [x.numpy() for x in blocked_inner_block_reference(
        *kernel_inputs(ts), topts, stall, K)]
    names = ["U", "V", "row0", "row1", "bvec", "ca", "ac", "basis", "ab",
             "gamma", "iscal", "fscal"]
    for name, r, o in zip(names, ref, out):
        if name in ("ca", "ac", "basis", "ab", "iscal"):
            assert np.array_equal(r, o), (name, r, o)
        else:
            np.testing.assert_allclose(o, r, rtol=0, atol=1e-12,
                                       err_msg=name)
    assert out[10][2] > 0  # the block pivoted


# ---------------------------------------------------------------------------
# the block driver
# ---------------------------------------------------------------------------

DRIVER_CASES = {
    **{f"random{s}-dantzig": (lambda s=s: _random(s), RULE_DANTZIG, 8)
       for s in range(6)},
    **{f"random{s}-devex": (lambda s=s: _random(s), RULE_DEVEX, 8)
       for s in range(6)},
    "bounded0-bland": (lambda: _random(0, bounded=True), RULE_BLAND, 8),
    "cleanup": (_cleanup, RULE_DANTZIG, 4),
    "beale": (_beale, RULE_DANTZIG, 4),
    "unbounded": (_unbounded, RULE_DANTZIG, 128),
    "infeasible": (_infeasible, RULE_DANTZIG, 128),
    "eq24-dantzig": (_eq24, RULE_DANTZIG, 8),
    "eq24-devex": (_eq24, RULE_DEVEX, 8),
}


@pytest.mark.parametrize("case", list(DRIVER_CASES))
def test_kernel_engine_matches_pallas_driver(case):
    build_inst, rule, K = DRIVER_CASES[case]
    js, ts = _states(build_inst())
    jopts, topts = _opts(rule, max_iters=4000)
    ref = run_simplex_blocked_pallas(js, jopts, block=K, interpret=True)
    out = run_simplex_blocked_kernel(ts, topts, block=K)
    assert int(out.status) == int(ref.status)
    assert int(out.niter) == int(ref.niter)
    assert np.array_equal(out.basis.numpy(), np.asarray(ref.basis))
    assert np.array_equal(out.art_cols.numpy(), np.asarray(ref.art_cols))
    assert np.array_equal(out.col_active.numpy(),
                          np.asarray(ref.col_active))
    if int(ref.status) == Status.OPTIMAL:
        assert abs(float(out.objective()) - float(ref.objective())) < 1e-9


def test_kernel_engine_numeric_guard():
    """A NaN in an active pricing entry reports NUMERIC, as tpulp's."""
    c, A, b, hint = _random(0, m=4, n=6)
    js, ts = _states((c, A, b, hint), dtype="float32")
    js = js._replace(T=js.T.at[0, 0].set(jnp.nan))
    ts = ts._replace(T=ts.T.clone())
    ts.T[0, 0] = float("nan")
    jopts, topts = _opts(RULE_DANTZIG, dtype="float32", max_iters=50)
    ref = run_simplex_blocked_pallas(js, jopts, block=8, interpret=True)
    out = run_simplex_blocked_kernel(ts, topts, block=8)
    assert int(ref.status) == int(out.status) == Status.NUMERIC


def test_launch_counters_stay_zero_on_cpu():
    reset_launches()
    js, ts = _states(_random(0, bounded=True))
    out = run_simplex_blocked_kernel(ts, SolverOptions.for_dtype(
        torch.float64), block=8)
    assert int(out.status) == Status.OPTIMAL
    T, _ = fused_flush(ts.T.clone(), torch.zeros((2, ts.T.shape[0]),
                                                 dtype=torch.float64),
                       torch.zeros((2, ts.T.shape[1]), dtype=torch.float64),
                       torch.ones((ts.T.shape[1],), dtype=torch.int32),
                       1e-9, 1e-9)
    assert LAUNCHES == {"fused_flush": 0, "blocked_inner_block": 0,
                        "fused_fma": 0, "lane_dual": 0, "lane_primal": 0,
                        "lane_bounded": 0, "bounded_grid": 0,
                        "rank1_cluster": 0, "rank1_cluster_lanes": 0,
                        "rank1_grid": 0, "blocked_ray": 0,
                        "blocked_cluster": 0, "blocked_grid": 0,
                        "blocked_cluster_batch": 0, "fused_flush_batch": 0,
                        "blocked_ray_batch": 0, "shard_pivot": 0,
                        "shard_vectors": 0}


def test_nvcc_command_line():
    out = build.BUILD_DIR / build.LIB_NAME
    compiles, link = build.nvcc_commands(out)
    sources, objects, defines = [], [], []
    for cmd in compiles:
        assert cmd[0] == "nvcc"
        assert cmd[cmd.index("-gencode") + 1] == \
            "arch=compute_90a,code=sm_90a"
        for flag in ("-std=c++17", "-O3", "-fPIC", "-c"):
            assert flag in cmd
        (src,) = [pathlib.Path(x) for x in cmd if x.endswith(".cu")]
        sources.append(src)
        objects.append(cmd[cmd.index("-o") + 1])
        defines.append((src.name, *[x for x in cmd if x.startswith("-D")]))
    # the largest sources compile twice, their f32 and f64 entry points
    # apart
    split = ("bounded_grid.cu", "lanes.cu", "rank1_grid.cu")
    assert build.SPLIT_BY_TYPE == split
    assert sorted(p.name for p in sources) == sorted(
        ["blocked.cu", "blocked_cluster.cu", "blocked_grid.cu",
         "bounded_grid.cu", "flush.cu", "fma.cu", "inner_block.cu",
         "lanes.cu", "rank1_cluster.cu", "rank1_grid.cu", "shard_pivot.cu",
         *split])
    for name in split:
        assert sorted(d[1:] for d in defines if d[0] == name) == [
            ("-DTPULP_TYPES=1",), ("-DTPULP_TYPES=2",)]
    assert all(len(d) == 1 for d in defines if d[0] not in split)
    assert len(set(objects)) == len(objects)
    assert all(p.parent == ROOT / "tpulp_torch" / "kernels" / "csrc"
               for p in sources)
    assert link[0] == "nvcc" and "-shared" in link
    assert link[link.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert link[link.index("-o") + 1] == str(out)
    assert sorted(link[link.index("-o") + 2:]) == sorted(objects)
    assert all(pathlib.Path(o).parent == out.parent for o in objects)
    assert out.relative_to(ROOT).parts[0] == "build"
    verbose, _ = build.nvcc_commands(out, verbose=True)
    assert all("-Xptxas=-v" in cmd for cmd in verbose)


# the inner-block kernel's launch plan: the shapes chip_smoke.py runs, K at
# its limit, and a tableau whose owned vectors overflow shared memory
PLAN_CASES = {
    "main_path_f64": ((1538, 3073, 128, torch.float64),
                      ("resident", 97, 16, 32, 53_120)),
    "bench_f32": ((4098, 8193, 256, torch.float32),
                  ("resident", 132, 32, 64, 102_656)),
    "bench_f64": ((4098, 8193, 256, torch.float64),
                  ("resident", 132, 32, 64, 204_544)),
    "bench_f32_k1024": ((4098, 8193, 1024, torch.float32),
                        ("streaming", 132, 32, 64, 10_496)),
    "bench_f64_k1024": ((4098, 8193, 1024, torch.float64),
                        ("streaming", 132, 32, 64, 20_224)),
    "tiny": ((4, 7, 8, torch.float64), ("resident", 1, 8, 8, 1_728)),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_inner_block_plan(case):
    from tpulp_torch.kernels.block import SMEM_PER_BLOCK, inner_block_plan

    (M, N, K, dt), want = PLAN_CASES[case]
    plan = inner_block_plan(M, N, K, dt, 132)
    got = (plan.variant, plan.grid, plan.rows, plan.cols, plan.smem)
    assert got == want
    assert plan.rows * plan.grid >= M and plan.cols * plan.grid >= N
    assert plan.rows % 8 == 0 and plan.cols % 8 == 0
    assert plan.smem < SMEM_PER_BLOCK and plan.barriers_per_pivot == 2
    tsize = 4 if dt == torch.float32 else 8
    slab = (plan.rows + plan.cols) * K * tsize
    assert (plan.smem > slab) == (plan.variant == "resident")
    # streaming can always be asked for; resident only where it fits
    assert inner_block_plan(M, N, K, dt, 132,
                            variant="streaming").variant == "streaming"
    if plan.variant == "streaming":
        with pytest.raises(ValueError, match="shared memory"):
            inner_block_plan(M, N, K, dt, 132, variant="resident")


def test_inner_block_plan_refuses():
    from tpulp_torch.kernels.block import inner_block_plan

    with pytest.raises(ValueError, match="shared memory"):
        inner_block_plan(102, 2_000_000, 256, torch.float64, 132)
    for K in (0, 1025):
        with pytest.raises(ValueError, match="outside"):
            inner_block_plan(4098, 8193, K, torch.float32, 132)


# ---------------------------------------------------------------------------
# on a card only: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cuda_kernels_match_plain_versions(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs these checks "
                    "at the bench shape)")
    c, A, b, hint = _random(0, m=64, n=64, bounded=True)
    from tpulp_torch import make_state

    tt = getattr(torch, dtype)
    ts = make_state(c, A, b, hint, dtype=tt, device="cuda")
    opts = eta_scaled_options(SolverOptions.for_dtype(tt), tt)
    stall = opts.resolved_stall_limit(ts.m, ts.n)
    ins = kernel_inputs(ts)
    k = blocked_inner_block(*ins, opts, stall, 16)
    p = blocked_inner_block_reference(*ins, opts, stall, 16)
    assert torch.equal(k[10], p[10]) and torch.equal(k[7], p[7])
    tol = 1e-4 if dtype == "float32" else 1e-10
    for i in range(5):
        torch.testing.assert_close(k[i], p[i], rtol=0, atol=tol)
    Tk, scan_k = fused_flush(ins[0].clone(), k[0], k[1], k[5], opts.opt_tol,
                             opts.piv_tol)
    Tr, _ = fused_flush_reference(ins[0].clone(), k[0], k[1], k[5],
                                  opts.opt_tol, opts.piv_tol)
    torch.testing.assert_close(Tk, Tr, rtol=0, atol=tol)
    scan = torch.stack([(k[5] > 0) & (Tk[0] < -opts.opt_tol),
                        (Tk[2:] > opts.piv_tol).any(dim=0)]).to(torch.int32)
    assert torch.equal(scan_k, scan)

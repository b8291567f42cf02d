"""``tpulp_torch.kernels.shard_pivot`` on the CPU: the plain versions of the
sharded pivot (``shard_pivot_reference``) and of the rank-K sharded
running vectors (``shard_vectors_reference``) against the compositions
the sharded drivers ran before them, bit for bit, and against tpulp's
expressions as jitted XLA computes them; the wrappers on CPU tensors; the
custom op's fake and vmap rule; the launch plan.

The cases (seeded numpy data, f32 and f64): a solo block; the block and
RHS as views of frames (the lane-sharded steps' layout); the idle step's
no-op pivot on (row 2, ``basis[0]``); the entering column on another
shard; the bounded step's gate closed (an entering flip alone, an idle
step), an entering flip, a leaving flip (an upper hit), a flip of a
column on another shard; NaN and inf entries in the block; lanes under
``torch.func.vmap``, through the wrapper and through the custom op's
vmap rule, with per-lane pivots and some operands unbatched."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulp_torch.kernels import LAUNCHES, reset_launches
from tpulp_torch.kernels.fma import fused_fma
from tpulp_torch.kernels.shard_pivot import (PIVOT_THREADS, Flip,
                                             shard_pivot, shard_pivot_op,
                                             shard_pivot_plan,
                                             shard_pivot_reference,
                                             shard_vectors,
                                             shard_vectors_reference)
from tpulp_torch.solve.driver import put, take

torch.set_num_threads(1)
pytestmark = pytest.mark.filterwarnings(
    "error:There is a performance drop")

DTYPES = {"float32": (torch.float32, np.float32),
          "float64": (torch.float64, np.float64)}
R, N, SHARD = 11, 13, 1  # a block of 11 rows, shard 1 of the columns


# ---------------------------------------------------------------------------
# the compositions the drivers ran before (shard/sharded.py's pivot_local
# and shard/sharded_bounded.py's gate and flip), statement for statement
# ---------------------------------------------------------------------------

def parent_pivot_local(T, rhs, u_eff, rg, owner_eff, j_local_eff):
    nrows, n_local = T.shape
    invp = 1.0 / take(u_eff, rg)
    prow = take(T, rg, 0) * invp
    Tn = fused_fma(T, u_eff[:, None], prow[None, :], -1.0)
    is_rg = (torch.arange(nrows, device=T.device) == rg)[:, None]
    Tn = torch.where(is_rg, prow[None, :], Tn)
    is_j = owner_eff & (torch.arange(n_local, device=T.device)
                        == j_local_eff)
    Tn = torch.where(is_j[None, :], is_rg.to(T.dtype), Tn)
    rhs_piv = take(rhs, rg) * invp
    rhsn = put(fused_fma(rhs, u_eff, rhs_piv, -1.0), rg, rhs_piv)
    return Tn, rhsn, invp


def parent_step(T, rhs, u_eff, rg, j_eff, index, do_pivot=None, flip=None):
    """The drivers' pivot (and the bounded step's gate and flip) as they
    composed it."""
    nrows, n_local = T.shape
    Tn, rhsn, invp = parent_pivot_local(T, rhs, u_eff, rg,
                                        (j_eff // n_local) == index,
                                        j_eff % n_local)
    if do_pivot is None:
        return Tn, rhsn
    Tn = torch.where(do_pivot, Tn, T)
    rhsn = torch.where(do_pivot, rhsn, rhs)
    do_flip, do_flip_enter, fcol, uf, u = flip
    is_rg = torch.arange(nrows, device=T.device) == rg
    colv = torch.where(do_flip_enter, u,
                       torch.where(is_rg, invp, -u_eff * invp))
    rhsn = fused_fma(rhsn, colv, uf, -1.0)
    is_fcol = (((fcol // n_local) == index)
               & (torch.arange(n_local, device=T.device) == fcol % n_local)
               & do_flip)
    Tn = torch.where(is_fcol[None, :], -Tn, Tn)
    return Tn, rhsn


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def as_bits(x: torch.Tensor) -> torch.Tensor:
    """The bits of a float tensor (NaN payloads and zero signs included)."""
    return x.contiguous().view(torch.int64 if x.dtype == torch.float64
                               else torch.int32)


def assert_bits(a, b, label=""):
    assert a.shape == b.shape and a.dtype == b.dtype, label
    assert torch.equal(as_bits(a), as_bits(b)), label


def _t(x, dtype=None):
    return torch.tensor(x, dtype=dtype)


# kind -> (rg, global entering column, do_pivot, flip: None or (do_flip,
# enter, global flipped column)); shard SHARD owns columns N .. 2N - 1
CASES = {
    "pivot": (5, SHARD * N + 4, None, None),
    "other_owner": (7, 2, None, None),
    "noop": (2, SHARD * N + 3, None, None),
    "gate_closed": (2, SHARD * N + 3, False, (False, False, 0)),
    "enter_flip": (2, SHARD * N + 3, False, (True, True, SHARD * N + 9)),
    "leave_flip": (6, SHARD * N + 4, True, (True, False, SHARD * N + 8)),
    "flip_other_shard": (4, SHARD * N + 1, True, (True, False, 3)),
    "pivot_no_flip": (9, SHARD * N + 12, True, (False, False, SHARD * N)),
}


def make_case(kind, dtype, seed=0, frame=False, nonfinite=False):
    """(T, rhs, u_eff, rg, j_eff, do_pivot, flip) of a case; the idle
    kinds pivot on (row 2, a column that is the exact unit vector on row
    2), as the drivers' idle step does."""
    rg, j, gate, fl = CASES[kind]
    rng = np.random.default_rng(seed)
    fr = torch.tensor(rng.normal(size=(R, N + 1))).to(dtype)
    if nonfinite:
        fr[3, 5], fr[8, 1], fr[0, 11] = float("nan"), float("inf"), \
            -float("inf")
    u = torch.tensor(rng.normal(size=R)).to(dtype)
    if rg == 2 and gate is not True:
        # the no-op pivot: u_eff is basis[0]'s column, e_2, and that column
        # of the block (when it is on this shard) is e_2 as well
        u = (torch.arange(R) == 2).to(dtype)
        if j // N == SHARD:
            fr[:, j % N] = u
    T, rhs = (fr[:, :-1], fr[:, -1]) if frame else \
        (fr[:, :-1].clone(), fr[:, -1].clone())
    do_pivot = None if gate is None else _t(gate)
    flip = None
    if fl is not None:
        do_flip, enter, fcol = fl
        u_in = torch.tensor(rng.normal(size=R)).to(dtype)
        uf = _t(float(rng.uniform(1, 3)) if do_flip else 0.0, dtype)
        flip = Flip(_t(do_flip), _t(enter), _t(fcol), uf, u_in)
    return T, rhs, u, _t(rg), _t(j), do_pivot, flip


KINDS = list(CASES)


@pytest.mark.parametrize("frame", [False, True], ids=["solo", "frame"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_reference_is_the_parent_composition(dt, kind, frame):
    T, rhs, u, rg, j, gate, flip = make_case(kind, DTYPES[dt][0],
                                             seed=len(kind), frame=frame)
    want = parent_step(T, rhs, u, rg, j, SHARD, gate, flip)
    for fn in (shard_pivot_reference, shard_pivot):
        got = fn(T, rhs, u, rg, j, SHARD, gate, flip)
        for g, w, name in zip(got, want, ("T", "rhs")):
            assert_bits(g, w, f"{fn.__name__} {kind} {name}")


@pytest.mark.parametrize("kind", ["pivot", "leave_flip", "enter_flip"])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_nonfinite_entries_travel_as_in_the_parent(dt, kind):
    T, rhs, u, rg, j, gate, flip = make_case(kind, DTYPES[dt][0], seed=3,
                                             nonfinite=True)
    want = parent_step(T, rhs, u, rg, j, SHARD, gate, flip)
    got = shard_pivot_reference(T, rhs, u, rg, j, SHARD, gate, flip)
    assert torch.isnan(want[0]).any()
    for g, w in zip(got, want):
        assert_bits(g, w, kind)


def test_noop_pivot_leaves_the_block():
    """The idle step's pivot on (row 2, basis[0]) changes no value (only,
    where an entry is -0.0, its sign)."""
    T, rhs, u, rg, j, _, _ = make_case("noop", torch.float64, seed=5)
    Tn, rhsn = shard_pivot_reference(T, rhs, u, rg, j, SHARD)
    assert torch.equal(Tn + 0.0, T + 0.0)
    assert torch.equal(rhsn + 0.0, rhs + 0.0)
    gated = make_case("gate_closed", torch.float64, seed=5)
    Tg, rg_ = shard_pivot_reference(*gated[:5], SHARD, *gated[5:])
    assert_bits(Tg, gated[0])
    assert_bits(rg_, gated[1])


def _lanes(dtype, L=5, seed=11):
    """L lanes of frames, per-lane pivots (one lane idle, one pivoting on
    another shard's column), as the lane-sharded steps hold them."""
    rng = np.random.default_rng(seed)
    fr = torch.tensor(rng.normal(size=(L, R, N + 1))).to(dtype)
    u = torch.tensor(rng.normal(size=(L, R))).to(dtype)
    rg = torch.tensor(rng.integers(2, R, size=L))
    j = torch.tensor(SHARD * N + rng.integers(0, N, size=L))
    rg[1], j[1] = 2, SHARD * N + 6
    u[1] = (torch.arange(R) == 2).to(dtype)
    fr[1, :, 6] = u[1]
    j[3] = 4  # another shard's column
    return fr, u, rg, j


@pytest.mark.parametrize("dt", list(DTYPES))
def test_lanes_under_vmap(dt):
    """The lane-sharded steps' pivot: vmapped over lanes of frame views,
    through the wrapper and through the custom op's vmap rule, equal to
    the parent's vmapped composition lane for lane."""
    fr, u, rg, j = _lanes(DTYPES[dt][0])
    T, rhs = fr[..., :-1], fr[..., -1]
    want = torch.func.vmap(
        lambda T, b, u, r, j: parent_step(T, b, u, r, j, SHARD))(
            T, rhs, u, rg, j)
    got = torch.func.vmap(
        lambda T, b, u, r, j: shard_pivot(T, b, u, r, j, SHARD))(
            T, rhs, u, rg, j)
    op = torch.func.vmap(
        lambda T, b, u, r, j: shard_pivot_op(T, b, u, r, j, SHARD))(
            T, rhs, u, rg, j)
    for k in range(2):
        assert_bits(got[k], want[k])
    assert op.shape == (fr.shape[0], R, N + 1)
    assert_bits(op[..., :-1], want[0])
    assert_bits(op[..., -1], want[1])


@pytest.mark.parametrize("dt", list(DTYPES))
def test_vmap_rule_with_unbatched_operands_and_flips(dt):
    """The op's vmap rule when some operands have no lane axis (a shared
    pivot column, a shared gate) and with the bounded step's gate and
    flip: each lane the plain version's."""
    dtype = DTYPES[dt][0]
    fr, u, rg, j = _lanes(dtype, seed=12)
    T, rhs = fr[..., :-1], fr[..., -1]
    L = fr.shape[0]
    rng = np.random.default_rng(13)
    shared_u = u[0]
    gate = torch.tensor([True, False, True, False, True])
    do_flip = torch.tensor([True, True, False, True, False])
    enter = torch.tensor([False, True, False, False, False])
    fcol = torch.tensor(SHARD * N + rng.integers(0, N, size=L))
    uf = torch.tensor(rng.uniform(1, 2, size=L)).to(dtype) * do_flip
    u_in = torch.tensor(rng.normal(size=(L, R))).to(dtype)

    def lane(k):
        return parent_step(T[k], rhs[k], shared_u, rg[k], j[k], SHARD,
                           torch.tensor(True),
                           Flip(do_flip[k], enter[k], fcol[k], uf[k],
                                u_in[k]))

    got = torch.func.vmap(
        lambda T, b, r, j, df, en, fc, uf, ui: shard_pivot_op(
            T, b, shared_u, r, j, SHARD, torch.tensor(True), df, en, fc, uf,
            ui))(T, rhs, rg, j, do_flip, enter, fcol, uf, u_in)
    for k in range(L):
        Tn, rhsn = lane(k)
        assert_bits(got[k, :, :-1], Tn, f"lane {k}")
        assert_bits(got[k, :, -1], rhsn, f"lane {k}")
    # a gate per lane, the pivot column shared
    got = torch.func.vmap(
        lambda T, b, r, j, g: shard_pivot_op(T, b, shared_u, r, j, SHARD, g),
        in_dims=(0, 0, 0, 0, 0))(T, rhs, rg, j, gate)
    for k in range(L):
        Tn, rhsn, _ = parent_pivot_local(T[k], rhs[k], shared_u, rg[k],
                                         (j[k] // N) == SHARD, j[k] % N)
        if not gate[k]:
            Tn, rhsn = T[k], rhs[k]
        assert_bits(got[k, :, :-1], Tn, f"gated lane {k}")
        assert_bits(got[k, :, -1], rhsn, f"gated lane {k}")


def test_op_outside_vmap_and_the_fake():
    T, rhs, u, rg, j, gate, flip = make_case("leave_flip", torch.float64,
                                             seed=7)
    Tn, rhsn = parent_step(T, rhs, u, rg, j, SHARD, gate, flip)
    out = shard_pivot_op(T, rhs, u, rg, j, SHARD, gate, *flip)
    assert_bits(out[:, :-1], Tn)
    assert_bits(out[:, -1], rhsn)
    meta = [torch.empty(x.shape, dtype=x.dtype, device="meta")
            for x in (T, rhs, u, rg, j)]
    fake = shard_pivot_op(*meta, SHARD)
    assert fake.shape == (R, N + 1) and fake.device.type == "meta"
    assert fake.dtype == torch.float64


def test_cpu_tensors_never_launch_and_mixed_devices_raise():
    reset_launches()
    T, rhs, u, rg, j, gate, flip = make_case("enter_flip", torch.float32)
    shard_pivot(T, rhs, u, rg, j, SHARD, gate, flip)
    w = torch.ones(R, dtype=torch.float32)
    shard_vectors(T[0], T[1], rhs, w, T[3], rhs[4])
    assert LAUNCHES["shard_pivot"] == LAUNCHES["shard_vectors"] == 0
    with pytest.raises(ValueError, match="CPU or on one CUDA"):
        shard_pivot(T, rhs, u.to("meta"), rg, j, SHARD)
    with pytest.raises(ValueError, match="CPU or on one CUDA"):
        shard_vectors(T[0], T[1], rhs, w.to("meta"), T[3], rhs[4])


# ---------------------------------------------------------------------------
# tpulp's expressions as XLA computes them (tpulp/shard/sharded.py:393-405,
# tpulp/shard/sharded_bounded.py:218-248, tpulp/shard/sharded_blocked.py:
# 242-244)
# ---------------------------------------------------------------------------

def tpulp_pivot(T, rhs, u_eff, rg, j_eff, ax, do_pivot, do_flip,
                do_flip_enter, fcol, uf, u, bounded):
    nrows, n_local = T.shape
    dtype = T.dtype
    owner_eff = (j_eff // n_local) == ax
    j_local_eff = j_eff % n_local
    piv = u_eff[rg]
    invp = 1.0 / piv
    prow = T[rg, :] * invp
    Tn = T - u_eff[:, None] * prow[None, :]
    is_rg = (jnp.arange(nrows) == rg)[:, None]
    Tn = jnp.where(is_rg, prow[None, :], Tn)
    unit = is_rg[:, 0].astype(dtype)
    is_j = owner_eff & (jnp.arange(n_local) == j_local_eff)
    Tn = jnp.where(is_j[None, :], unit[:, None], Tn)
    rhs_piv = rhs[rg] * invp
    rhsn = rhs - u_eff * rhs_piv
    rhsn = rhsn.at[rg].set(rhs_piv)
    if not bounded:
        return Tn, rhsn
    Tn = jnp.where(do_pivot, Tn, T)
    rhsn = jnp.where(do_pivot, rhsn, rhs)
    colv_leave = jnp.where((jnp.arange(nrows) == rg), invp, -u_eff * invp)
    colv = jnp.where(do_flip_enter, u, colv_leave)
    rhsn = rhsn - uf * colv
    owner_f = (fcol // n_local) == ax
    is_fcol = owner_f & (jnp.arange(n_local) == (fcol % n_local)) & do_flip
    Tn = jnp.where(is_fcol[None, :], -Tn, Tn)
    return Tn, rhsn


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_reference_matches_tpulps_xla_pivot(dt, kind):
    T, rhs, u, rg, j, gate, flip = make_case(kind, DTYPES[dt][0],
                                             seed=len(kind) + 20)
    bounded = gate is not None
    fl = flip if bounded else Flip(_t(False), _t(False), _t(0),
                                   _t(0.0, T.dtype), u)
    args = [jnp.asarray(x.numpy()) for x in
            (T, rhs, u, rg, j, _t(True) if gate is None else gate) + tuple(fl)]
    ref = jax.jit(tpulp_pivot, static_argnums=(5, 12))(
        *args[:5], SHARD, *args[5:], bounded)
    got = shard_pivot_reference(T, rhs, u, rg, j, SHARD, gate, flip)
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy().view(np.uint8),
                              np.asarray(r).view(np.uint8)), kind


def _vectors(dtype, n=17, M=11, seed=4):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.normal(size=s)).to(dtype)
            for s in ((n,), (n,), (M,), (M,), (n,), ())]


@pytest.mark.parametrize("dt", list(DTYPES))
def test_vectors_reference_is_the_parent_composition(dt):
    row0, row1, bvec, w, vrow, vrow_rhs = _vectors(DTYPES[dt][0])
    want = (fused_fma(row0, w[0], vrow), fused_fma(row1, w[1], vrow),
            fused_fma(bvec, w, vrow_rhs))
    for fn in (shard_vectors_reference, shard_vectors):
        for g, r in zip(fn(row0, row1, bvec, w, vrow, vrow_rhs), want):
            assert_bits(g, r, fn.__name__)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_vectors_reference_matches_tpulps_xla(dt):
    xs = _vectors(DTYPES[dt][0], seed=5)
    ref = jax.jit(lambda row0, row1, bvec, w, vrow, vrow_rhs: (
        row0 + w[0] * vrow, row1 + w[1] * vrow, bvec + w * vrow_rhs))(
            *(jnp.asarray(x.numpy()) for x in xs))
    for g, r in zip(shard_vectors_reference(*xs), ref):
        assert np.array_equal(g.numpy().view(np.uint8),
                              np.asarray(r).view(np.uint8))


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L, R_, N_, vec", [
    (1, 1538, 3072, 2), (1, 1538, 3072, 4), (64, 66, 192, 1),
    (128, 59, 113, 1), (1, 130, 256, 1), (1, 3, 1, 1), (7, 1, 5000, 2)],
    ids=["9b_f64", "9b_f32", "10a", "10b", "9c", "tiny", "one_row"])
def test_launch_plan_covers_the_block_once(L, R_, N_, vec):
    """Each (row, column) of every lane falls in exactly one CTA's tile
    and row chunk; a CTA is whole warps within ``PIVOT_THREADS``."""
    p = shard_pivot_plan(L, R_, N_, vec)
    assert p.tx % 32 == 0 and p.tx * p.ty <= PIVOT_THREADS
    assert p.tiles * p.tx * p.vec >= N_ > (p.tiles - 1) * p.tx * p.vec
    assert p.chunks * p.rows >= R_ > (p.chunks - 1) * p.rows
    assert p.chunks <= 65535
    if L * R_ * N_ >= 1 << 20:
        assert p.tiles * p.chunks * L >= 4 * 132  # the SMs kept busy

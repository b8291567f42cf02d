"""``tpulp_torch.kernels.fused_fma`` on the CPU: one rounding per element
(as tpulp's XLA fusion), its plain version ``torch.addcmul`` under
``torch.func.vmap`` with every batching pattern the engines use, both
called directly and through the custom op ``fma_op`` and its vmap rule
(never the per-sample fallback), its fake for meta tensors, and the
refusals."""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulp_torch.kernels import LAUNCHES, fused_fma, reset_launches
from tpulp_torch.kernels.fma import fma_op

torch.set_num_threads(1)
pytestmark = pytest.mark.filterwarnings(
    "error:There is a performance drop")

DTYPES = {"float32": (torch.float32, np.float32),
          "float64": (torch.float64, np.float64)}


def _data(shapes, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.normal(size=s)).to(dtype) for s in shapes]


@pytest.mark.parametrize("value", [1.0, -1.0, 0.5])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_one_rounding_per_element(dt, value):
    """fused_fma(c, a, b, v) is c + v a b rounded once (v a is exact for
    these v): the exact rational result, rounded to the dtype."""
    tdt, ndt = DTYPES[dt]
    c, a, b = _data([(37,), (37,), (37,)], tdt, seed=1)
    out = fused_fma(c, a, b, value).numpy()
    exact = np.array([float(Fraction(float(ci)) + Fraction(value)
                            * Fraction(float(ai)) * Fraction(float(bi)))
                      for ci, ai, bi in zip(c.tolist(), a.tolist(),
                                            b.tolist())])
    # float() of the exact sum rounds once to f64; f32 needs the rational
    # rounded straight to f32, which np.float32(f64) does unless the f64
    # rounding lands on an f32 midpoint (not on this seed)
    assert np.array_equal(out, exact.astype(ndt))


@pytest.mark.parametrize("dt", list(DTYPES))
def test_matches_xla_rank1_update(dt):
    """tpulp's rank-1 pivot ``T - col (x) row`` as jitted XLA fuses it, bit
    for bit."""
    tdt, ndt = DTYPES[dt]
    T, col, row = _data([(9, 13), (9,), (13,)], tdt, seed=2)
    ref = jax.jit(lambda T, c, r: T - c[:, None] * r[None, :])(
        jnp.asarray(T.numpy()), jnp.asarray(col.numpy()),
        jnp.asarray(row.numpy()))
    out = fused_fma(T, col[:, None], row[None, :], -1.0)
    assert np.array_equal(out.numpy(), np.asarray(ref))


# (shapes of c, a, b; vmap in_dims): the engines' patterns and a few more
VMAP_CASES = {
    "rank1_pivot": ([(6, 5, 7), (6, 5, 1), (6, 1, 7)], (0, 0, 0)),
    "rhs_rewrite": ([(6, 5), (6, 1), (6, 5)], (0, 0, 0)),
    "scalar_weight": ([(6, 7), (6,), (6, 7)], (0, 0, 0)),
    "unbatched_b": ([(6, 7), (6, 7), (7,)], (0, 0, None)),
    "unbatched_scalar_c": ([(6, 7), (), (6, 7)], (0, None, 0)),
    "batch_dim_1": ([(5, 6), (6, 5), (5, 6)], (1, 0, 1)),
}


ENTRIES = {"fused_fma": fused_fma, "fma_op": fma_op}


@pytest.mark.parametrize("entry", list(ENTRIES))
@pytest.mark.parametrize("case", list(VMAP_CASES))
@pytest.mark.parametrize("dt", ["float32", "float64"])
def test_vmap_equals_addcmul(case, dt, entry):
    shapes, in_dims = VMAP_CASES[case]
    c, a, b = _data(shapes, DTYPES[dt][0], seed=3)
    fma = ENTRIES[entry]
    out = torch.func.vmap(lambda c, a, b: fma(c, a, b, -1.0),
                          in_dims=in_dims)(c, a, b)
    ref = torch.func.vmap(lambda c, a, b: torch.addcmul(c, a, b, value=-1.0),
                          in_dims=in_dims)(c, a, b)
    assert out.shape == ref.shape and torch.equal(out, ref)


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_nested_vmap_and_scalar_lanes(entry):
    fma = ENTRIES[entry]
    c, a, b = _data([(3, 4, 5), (3, 4), (5,)], torch.float64, seed=4)
    f = torch.func.vmap(torch.func.vmap(
        lambda c, a, b: fma(c, a, b), in_dims=(0, 0, None)),
        in_dims=(0, 0, None))
    assert torch.equal(f(c, a, b), torch.addcmul(c, a[..., None], b))
    # logical rank 0 on every operand
    x, y, z = _data([(6,), (6,), (6,)], torch.float64, seed=5)
    assert torch.equal(torch.func.vmap(fma)(x, y, z),
                       torch.addcmul(x, y, z))


def test_op_outside_vmap_is_the_plain_version():
    """``fma_op`` on plain CPU tensors runs ``addcmul``, as ``fused_fma``
    does without the op's dispatch."""
    c, a, b = _data([(5, 7), (5, 1), (7,)], torch.float64, seed=7)
    ref = torch.addcmul(c, a, b, value=-1.0)
    assert torch.equal(fma_op(c, a, b, -1.0), ref)
    assert torch.equal(fused_fma(c, a, b, -1.0), ref)


def test_fake_and_launch_count():
    reset_launches()
    out = fused_fma(*(torch.empty(s, device="meta", dtype=torch.float32)
                      for s in [(4, 1), (1, 3), ()]))
    assert out.shape == (4, 3) and out.device.type == "meta"
    fused_fma(*_data([(4,), (4,), (4,)], torch.float64))
    assert LAUNCHES["fused_fma"] == 0


def test_refusals():
    c, a, b = _data([(4,), (4,), (4,)], torch.float64)
    with pytest.raises(ValueError, match="CPU or on one CUDA"):
        fused_fma(c, a, torch.empty(4, dtype=torch.float64, device="meta"))
    with pytest.raises(ValueError, match="one dtype"):
        fused_fma(c, a, b.float())


@pytest.mark.parametrize("shapes", [
    [(128, 59, 114), (128, 59, 1), (128, 1, 114)],
    [(128, 59), (128, 1), (128, 59)],
    [(3073,), (), (3073,)],
    [(5, 1, 7), (3, 1), (7,)],
], ids=["rank1_pivot", "rhs_rewrite", "running_vector", "mixed_ranks"])
def test_kernel_geometry_reads_the_broadcast_operands(shapes):
    """The rank-4 index and strides the CUDA kernel reads each operand
    with (a strided view among them) address exactly the broadcast
    operand."""
    from tpulp_torch.kernels.fma import MAX_RANK, _shape, geometry

    ops = _data(shapes, torch.float64, seed=6)
    ops[0] = torch.randn(tuple(shapes[0])[::-1], dtype=torch.float64).T \
        if len(shapes[0]) == 2 else ops[0]
    shape = _shape(*ops)
    assert shape == tuple(torch.broadcast_shapes(*[x.shape for x in ops]))
    dims, strides = geometry(shape, ops)
    n = int(np.prod(dims))
    for k, x in enumerate(ops):
        st = strides[k * MAX_RANK:(k + 1) * MAX_RANK]
        flat = torch.as_strided(x, (x.untyped_storage().nbytes() // 8,),
                                (1,), 0)
        idx = np.zeros(n, dtype=np.int64)
        r = np.arange(n)
        for d in range(MAX_RANK - 1, -1, -1):
            idx += (r % dims[d]) * st[d]
            r //= dims[d]
        got = flat[torch.as_tensor(idx + x.storage_offset())]
        assert torch.equal(got, x.expand(shape).reshape(-1))


def test_launch_plan_is_cached_by_layout():
    """The launch plan (shape, element count, geometry array) is built once
    per layout of the three operands: equal to ``geometry``'s, reused for
    new tensors of that layout, and rebuilt for a strided view."""
    from tpulp_torch.kernels.fma import _plan, _shape, geometry

    c, a, b = _data([(5, 7), (5, 1), (7,)], torch.float64, seed=8)
    shape, n, geom = _plan(c, a, b)
    dims, strides = geometry(_shape(c, a, b), (c, a, b))
    assert shape == (5, 7) and n == 35 and list(geom) == dims + strides
    assert _plan(*_data([(5, 7), (5, 1), (7,)], torch.float64))[2] is geom
    ct = torch.randn(7, 5, dtype=torch.float64).T
    _, _, geom_t = _plan(ct, a, b)
    assert geom_t is not geom and list(geom_t) == sum(
        geometry((5, 7), (ct, a, b)), [])

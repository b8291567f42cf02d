"""The sharded pivot's kernels on the card against their plain versions on
the same inputs, bit for bit: ``shard_pivot`` (``shard_pivot_reference``,
which on the card is the sharded drivers' former path: the FMA kernel and
``torch.where`` passes) and ``shard_vectors``
(``shard_vectors_reference``), each also against the plain version on
the CPU.

The layouts the sharded paths launch: a rank-1 pivot of 9b's block (1538
x 3072 and its RHS, f64 and f32; the 16-byte vector path), the bounded
step's pivot at 9c's width (128 x 256) with the gate closed, an entering
flip, a leaving flip and a flip on another shard, the idle step's no-op
pivot on (row 2, ``basis[0]``), the lane-sharded steps' frames under
``torch.func.vmap`` (64 lanes of 66 x 193 and 128 lanes of 59 x 114: the
scalar path, the output a frame) with per-lane pivots, a lane idle and a
lane pivoting on another shard's column, NaN and inf entries, and the
rank-K pivot's running vectors at 9a's shapes. Each launch counts one in
``LAUNCHES`` and launches no FMA.

Every test here needs a CUDA card (the ``cuda`` marker) and skips without
one. The file imports neither jax nor tpulp, so that it runs on a machine
with the card alone: chip_smoke.py's phase 9 runs it there with ``python
-m pytest --noconftest -m cuda -q -p no:cacheprovider
tests/test_torch_shard_pivot_card.py``."""

import numpy as np
import pytest
import torch

from tpulp_torch.kernels import LAUNCHES, reset_launches
from tpulp_torch.kernels.shard_pivot import (Flip, shard_pivot,
                                             shard_pivot_reference,
                                             shard_vectors,
                                             shard_vectors_reference)

torch.set_num_threads(1)

DTYPES = {"float32": torch.float32, "float64": torch.float64}
SHARD = 1  # the block is shard 1 of its columns


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py's phase 9 runs this "
                    "file there)")


def as_bits(x: torch.Tensor) -> torch.Tensor:
    """A float tensor's bits on the CPU, every NaN alike."""
    x = x.cpu().contiguous()
    ints = torch.int64 if x.dtype == torch.float64 else torch.int32
    nan = torch.isnan(x)
    return torch.where(nan, torch.zeros_like(x), x).view(ints) + nan.to(ints)


def assert_bits(a, b, label=""):
    assert a.shape == b.shape and a.dtype == b.dtype, label
    assert torch.equal(as_bits(a), as_bits(b)), label


# kind -> (rg, entering column on this shard (None: on shard 0), gate,
# flip: None or (do_flip, enter, flipped column on this shard or None))
KINDS = {
    "pivot": (5, 4, None, None),
    "other_owner": (7, None, None, None),
    "noop": (2, 3, None, None),
    "gate_closed": (2, 3, False, (False, False, 0)),
    "enter_flip": (2, 3, False, (True, True, 9)),
    "leave_flip": (6, 4, True, (True, False, 8)),
    "flip_other_shard": (4, 1, True, (True, False, None)),
}


def case(kind, R, N, dtype, seed=0, nonfinite=False):
    """(T, rhs, u_eff, rg, j_eff, do_pivot, flip) on the CPU."""
    rg, j, gate, fl = KINDS[kind]
    rng = np.random.default_rng(seed)
    T = torch.tensor(rng.normal(size=(R, N))).to(dtype)
    rhs = torch.tensor(rng.normal(size=R)).to(dtype)
    u = torch.tensor(rng.normal(size=R)).to(dtype)
    if nonfinite:
        T[3, 5], T[R - 1, 1], T[0, N - 2] = float("nan"), float("inf"), \
            -float("inf")
    if rg == 2 and gate is not True:
        u = (torch.arange(R) == 2).to(dtype)
        T[:, j] = u
    j_eff = SHARD * N + j if j is not None else 2
    flip = None
    if fl is not None:
        do_flip, enter, fcol = fl
        fcol = SHARD * N + fcol if fcol is not None else 1
        flip = Flip(torch.tensor(do_flip), torch.tensor(enter),
                    torch.tensor(fcol),
                    torch.tensor(float(rng.uniform(1, 3)) if do_flip
                                 else 0.0, dtype=dtype),
                    torch.tensor(rng.normal(size=R)).to(dtype))
    return (T, rhs, u, torch.tensor(rg), torch.tensor(j_eff),
            None if gate is None else torch.tensor(gate), flip)


def to_card(args):
    return tuple(None if x is None else
                 Flip(*(y.cuda() for y in x)) if isinstance(x, Flip)
                 else x.cuda() for x in args)


def held(args, label):
    """The kernel on the card: one launch, no FMA, bit for bit the plain
    version on the card and on the CPU."""
    cpu = shard_pivot_reference(*args[:5], SHARD, *args[5:])
    card = to_card(args)
    reset_launches()
    got = shard_pivot(*card[:5], SHARD, *card[5:])
    torch.cuda.synchronize()
    assert LAUNCHES["shard_pivot"] == 1 and LAUNCHES["fused_fma"] == 0
    plain = shard_pivot_reference(*card[:5], SHARD, *card[5:])
    for g, p, c, name in zip(got, plain, cpu, ("T", "rhs")):
        assert_bits(g, p, f"{label} {name} against the plain version")
        assert_bits(g, c, f"{label} {name} against the CPU")
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(DTYPES))
def test_9b_block(dt):
    _card()
    T, rhs, *rest = case("pivot", 1538, 3072, DTYPES[dt], seed=1)
    held((T, rhs, *rest), f"9b {dt}")


@pytest.mark.cuda
@pytest.mark.parametrize("nonfinite", [False, True])
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("dt", list(DTYPES))
def test_9c_bounded_kinds(dt, kind, nonfinite):
    _card()
    held(case(kind, 128, 256, DTYPES[dt], seed=len(kind),
              nonfinite=nonfinite), f"9c {kind} {dt}")


def lanes(L, M, W, dtype, seed):
    """L lanes of (M, W + 1) frames with per-lane pivots: lane 1 idle on
    (row 2, a unit column), lane 3 pivoting on shard 0's column, a NaN in
    lane 0."""
    rng = np.random.default_rng(seed)
    fr = torch.tensor(rng.normal(size=(L, M, W + 1))).to(dtype)
    u = torch.tensor(rng.normal(size=(L, M))).to(dtype)
    rg = torch.tensor(rng.integers(2, M, size=L))
    j = torch.tensor(SHARD * W + rng.integers(0, W, size=L))
    rg[1], j[1] = 2, SHARD * W + 6
    u[1] = (torch.arange(M) == 2).to(dtype)
    fr[1, :, 6] = u[1]
    j[3] = 4
    fr[0, 5, 7] = float("nan")
    return fr, u, rg, j


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 66, 192), (128, 59, 113)],
                         ids=["10a", "10b"])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_10_lanes_under_vmap(dt, shape):
    """The lane-sharded steps' pivot: one launch for every lane, a frame
    out, each lane bit for bit the plain version's."""
    _card()
    L, M, W = shape
    fr, u, rg, j = lanes(L, M, W, DTYPES[dt], seed=L)

    def step(fn):
        return torch.func.vmap(lambda T, b, u, r, j: fn(T, b, u, r, j,
                                                         SHARD))

    cpu = step(shard_pivot_reference)(fr[..., :-1], fr[..., -1], u, rg, j)
    frc, uc, rgc, jc = (x.cuda() for x in (fr, u, rg, j))
    reset_launches()
    got = step(shard_pivot)(frc[..., :-1], frc[..., -1], uc, rgc, jc)
    torch.cuda.synchronize()
    assert LAUNCHES["shard_pivot"] == 1 and LAUNCHES["fused_fma"] == 0
    assert got[0].stride()[1:] == (W + 1, 1)
    plain = step(shard_pivot_reference)(frc[..., :-1], frc[..., -1], uc,
                                        rgc, jc)
    for g, p, c in zip(got, plain, cpu):
        assert_bits(g, p, "against the plain version")
        assert_bits(g, c, "against the CPU")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(DTYPES))
def test_9a_vectors(dt):
    _card()
    rng = np.random.default_rng(9)
    n, M = 3072, 1538
    xs = [torch.tensor(rng.normal(size=s)).to(DTYPES[dt])
          for s in ((n,), (n,), (M,), (M,), (n,), ())]
    cpu = shard_vectors_reference(*xs)
    card = [x.cuda() for x in xs]
    reset_launches()
    got = shard_vectors(*card)
    torch.cuda.synchronize()
    assert LAUNCHES["shard_vectors"] == 1 and LAUNCHES["fused_fma"] == 0
    plain = shard_vectors_reference(*card)
    for g, p, c in zip(got, plain, cpu):
        assert_bits(g, p, "against the plain version")
        assert_bits(g, c, "against the CPU")

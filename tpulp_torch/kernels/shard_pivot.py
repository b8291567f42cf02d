"""``shard_pivot`` and ``shard_vectors``: the launches of
``csrc/shard_pivot.cu``, and their plain versions.

``shard_pivot`` is the whole local pivot of one column block of the
sharded drivers (``shard.sharded``'s rank-1 step, the lane-sharded primal
and dual steps of ``shard.sharded_batch``, and ``shard.sharded_bounded``'s
step with its gate and flip) in one launch that reads the block once and
writes it once. ``shard_vectors`` is the rank-K sharded pivot's three
running vectors (``shard.sharded_blocked``) in one launch. Each computes
what its plain version computes, bit for bit: ``shard_pivot_reference``
and ``shard_vectors_reference`` are the drivers' compositions moved here
statement for statement, and what the wrappers run on CPU tensors. On
CUDA tensors the wrappers launch the kernels, and raise where they cannot.

Under ``torch.func.vmap`` (the lane-sharded steps) a CUDA ``shard_pivot``
goes through ``shard_pivot_op``, a ``torch.library`` custom op with a fake
and a vmap rule, so that one launch serves every lane; it returns the
block with its RHS column appended (a frame), and the step goes on with
views of it. Outside vmap (the solo sharded drivers) the wrapper
launches directly (the op's dispatch costs more host time than the
launch) and writes the block and the RHS apart.
"""

from __future__ import annotations

import array
from typing import NamedTuple, Optional

import torch

from ..solve.driver import put, take
from .fma import fused_fma
from .launch import LAUNCHES, lib_for, on_cpu, raise_on, stream_of, suffix

__all__ = ["Flip", "shard_pivot", "shard_pivot_reference", "shard_pivot_op",
           "shard_pivot_plan", "shard_vectors", "shard_vectors_reference",
           "PIVOT_THREADS"]

PIVOT_THREADS = 256  # csrc/shard_pivot.cu's SP_THREADS
_ROWS_IN_FLIGHT = 4  # its SP_UNROLL
_CTAS = 1024  # the CTAs a launch aims at: ~8 a streaming multiprocessor
_is_batched = torch._C._functorch.is_batchedtensor


class Flip(NamedTuple):
    """The bounded step's column flip: ``do_flip`` (bool), ``enter`` (an
    entering flip), ``fcol`` (the flipped column, global, int64), ``uf``
    (its span, 0 without a flip) and ``u`` (the entering column as
    fetched)."""

    do_flip: torch.Tensor
    enter: torch.Tensor
    fcol: torch.Tensor
    uf: torch.Tensor
    u: torch.Tensor


class PivotPlan(NamedTuple):
    vec: int     # elements a thread loads at once (1: scalar)
    tx: int      # threads across the columns
    ty: int      # threads down the rows
    tiles: int   # column tiles (grid x)
    chunks: int  # row chunks (grid y)
    rows: int    # rows a chunk


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def shard_pivot_plan(L: int, R: int, N: int, vec: int) -> PivotPlan:
    """The launch of ``L`` lanes of (R, N) blocks, ``vec`` elements a load:
    a CTA is ``tx`` threads across the columns (whole warps, up to
    ``PIVOT_THREADS``) by ``ty`` rows; the rows are cut into chunks so
    that the grid has about ``_CTAS`` CTAs, each walking at least
    ``_ROWS_IN_FLIGHT`` rows a thread where the block has them."""
    tx = min(PIVOT_THREADS, _cdiv(_cdiv(N, vec), 32) * 32)
    ty = max(1, PIVOT_THREADS // tx)
    tiles = _cdiv(N, tx * vec)
    chunks = max(1, min(_cdiv(R, _ROWS_IN_FLIGHT * ty),
                        _cdiv(_CTAS, tiles * L)))
    rows = _cdiv(R, chunks)
    return PivotPlan(vec, tx, ty, tiles, _cdiv(R, rows), rows)


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------

def shard_pivot_reference(T, rhs, u_eff, rg, j_eff, index: int,
                          do_pivot=None, flip: Optional[Flip] = None):
    """The rank-1 pivot on this shard's (R, n_local) block ``T`` and the
    replicated RHS: row ``rg`` normalised, ``T - u (x) prow`` with one
    rounding per element, the entering column ``j_eff`` (on its owner,
    shard ``index``) snapped to the unit vector. With ``do_pivot`` an
    entering flip alone, or an idle step, leaves the block and the RHS as
    they were; with ``flip`` the RHS is folded by the flipped column's
    post-pivot values and that column negated on its owner. Returns (Tn,
    rhsn)."""
    nrows, n_local = T.shape
    owner_eff = (j_eff // n_local) == index
    j_local_eff = j_eff % n_local
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
    if do_pivot is not None:
        # an entering flip alone, or an idle step, leaves the block as it was
        Tn = torch.where(do_pivot, Tn, T)
        rhsn = torch.where(do_pivot, rhsn, rhs)
    if flip is not None:
        is_rg = torch.arange(nrows, device=T.device) == rg
        colv = torch.where(flip.enter, flip.u,
                           torch.where(is_rg, invp, -u_eff * invp))
        # rhs - uf * colv with one rounding, as XLA contracts it
        rhsn = fused_fma(rhsn, colv, flip.uf, -1.0)
        is_fcol = (((flip.fcol // n_local) == index)
                   & (torch.arange(n_local, device=T.device)
                      == flip.fcol % n_local)
                   & flip.do_flip)
        Tn = torch.where(is_fcol[None, :], -Tn, Tn)
    return Tn, rhsn


def shard_vectors_reference(row0, row1, bvec, w, vrow, vrow_rhs):
    """The rank-K sharded pivot's running vectors, one rounding each, as
    XLA fuses them: ``row0 + w[0] vrow``, ``row1 + w[1] vrow`` and
    ``bvec + w vrow_rhs``."""
    return (fused_fma(row0, w[0], vrow), fused_fma(row1, w[1], vrow),
            fused_fma(bvec, w, vrow_rhs))


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def _operands(T, rhs, u_eff, rg, j_eff, do_pivot, flip):
    return (T, rhs, u_eff, rg, j_eff) + ((do_pivot,) if do_pivot is not None
                                         else ()) + (tuple(flip) if flip
                                                     is not None else ())


def shard_pivot(T, rhs, u_eff, rg, j_eff, index: int, do_pivot=None,
                flip: Optional[Flip] = None):
    """``shard_pivot_reference``'s (Tn, rhsn): its plain version on CPU
    tensors, the kernel on CUDA tensors (``shard_pivot_op`` under
    ``torch.func.vmap``, one launch for every lane)."""
    ops = _operands(T, rhs, u_eff, rg, j_eff, do_pivot, flip)
    if on_cpu(*ops):
        return shard_pivot_reference(T, rhs, u_eff, rg, j_eff, index,
                                     do_pivot, flip)
    if any(_is_batched(x) for x in ops):
        f = flip if flip is not None else (None,) * 5
        fr = shard_pivot_op(T, rhs, u_eff, rg, j_eff, index, do_pivot, *f)
        return fr[..., :-1], fr[..., -1]
    Tn, rhsn = _launch(T[None], rhs[None], u_eff[None], rg[None],
                       j_eff[None], index,
                       None if do_pivot is None else do_pivot[None],
                       None if flip is None else Flip(*(x[None]
                                                        for x in flip)),
                       False)
    return Tn[0], rhsn[0]


def _lanes(x, L: int):
    """``x`` with a lane axis of ``L`` (a stride-0 one if it has none)."""
    return x.expand((L,) + tuple(x.shape[1:]))


def _launch(T, rhs, u, rg, jeff, index: int, gate, flip, frame: bool):
    """The kernel over L lanes: ``T`` (L, R, N), ``rhs`` and ``u`` (L, R),
    the per-lane scalars (L,). Returns the output frames (L, R, N + 1) when
    ``frame``, else (Tn, rhsn)."""
    L, R, N = T.shape
    dtype, dev = T.dtype, T.device
    fn = f"tpulp_shard_pivot_{suffix(dtype)}"
    if T.stride(-1) != 1:
        T = T.contiguous()
    floats = [rhs, u] + ([flip.uf, flip.u] if flip is not None else [])
    if any(x.dtype != dtype for x in floats):
        raise ValueError(f"shard_pivot: operands of one dtype, got "
                         f"{[x.dtype for x in [T] + floats]}")
    rg, jeff = rg.to(torch.int64), jeff.to(torch.int64)
    if gate is not None:
        gate = gate.to(torch.bool)
    if frame:
        fr = torch.empty((L, R, N + 1), dtype=dtype, device=dev)
        outT, outb = fr[:, :, :-1], fr[:, :, -1]
    else:
        outT = torch.empty((L, R, N), dtype=dtype, device=dev)
        outb = torch.empty((L, R), dtype=dtype, device=dev)
    es = T.element_size()
    vec = 16 // es
    strides = (T.stride(0), T.stride(1), outT.stride(0), outT.stride(1))
    if (N % vec or any(s % vec for s in strides)
            or T.data_ptr() % 16 or outT.data_ptr() % 16):
        vec = 1
    plan = shard_pivot_plan(L, R, N, vec)
    if flip is None:
        fptr, fst = [0] * 6, [0] * 6
    else:
        do_flip, enter = flip.do_flip.to(torch.bool), flip.enter.to(torch.bool)
        fcol = flip.fcol.to(torch.int64)
        fptr = [do_flip.data_ptr(), enter.data_ptr(), fcol.data_ptr(),
                flip.uf.data_ptr(), flip.u.data_ptr()]
        fst = [do_flip.stride(0), enter.stride(0), fcol.stride(0),
               flip.uf.stride(0), flip.u.stride(0), flip.u.stride(1)]
    ptrs = [T.data_ptr(), rhs.data_ptr(), u.data_ptr(), rg.data_ptr(),
            jeff.data_ptr(), 0 if gate is None else gate.data_ptr()]
    ptrs += fptr[:5] + [outT.data_ptr(), outb.data_ptr()]
    st = [T.stride(0), T.stride(1), rhs.stride(0), rhs.stride(1),
          u.stride(0), u.stride(1), rg.stride(0), jeff.stride(0),
          0 if gate is None else gate.stride(0)]
    st += fst[:3] + fst[3:] + [outT.stride(0), outT.stride(1),
                               outb.stride(0), outb.stride(1)]
    dims = [L, R, N, index, int(flip is not None), plan.vec, plan.tx,
            plan.ty, plan.tiles, plan.chunks, plan.rows]
    # the C side reads the arguments before the call returns
    args = array.array("q", ptrs + st + dims)
    lib = lib_for(dev)
    err = getattr(lib, fn)(args.buffer_info()[0], stream_of(dev))
    if err:
        raise_on(lib, err, "shard_pivot")
    LAUNCHES["shard_pivot"] += 1
    return fr if frame else (outT, outb)


def _reference_frame(T, rhs, u_eff, rg, j_eff, index, do_pivot, flip):
    """The plain version's (Tn, rhsn) as one frame."""
    Tn, rhsn = shard_pivot_reference(T, rhs, u_eff, rg, j_eff, index,
                                     do_pivot, flip)
    return torch.cat([Tn, rhsn[:, None]], dim=1)


@torch.library.custom_op("tpulp_torch::shard_pivot", mutates_args=())
def shard_pivot_op(T: torch.Tensor, rhs: torch.Tensor, u_eff: torch.Tensor,
                   rg: torch.Tensor, j_eff: torch.Tensor, index: int,
                   do_pivot: Optional[torch.Tensor] = None,
                   do_flip: Optional[torch.Tensor] = None,
                   enter: Optional[torch.Tensor] = None,
                   fcol: Optional[torch.Tensor] = None,
                   uf: Optional[torch.Tensor] = None,
                   u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``shard_pivot`` as a ``torch.library`` op with a fake and a vmap
    rule, returning the pivoted block with its RHS column appended (R, N
    + 1): the form ``torch.func.vmap`` batches into one launch."""
    flip = None if do_flip is None else Flip(do_flip, enter, fcol, uf, u)
    if on_cpu(T):
        return _reference_frame(T, rhs, u_eff, rg, j_eff, index, do_pivot,
                                flip)
    return _launch(T[None], rhs[None], u_eff[None], rg[None], j_eff[None],
                   index, None if do_pivot is None else do_pivot[None],
                   None if flip is None else Flip(*(x[None] for x in flip)),
                   True)[0]


@shard_pivot_op.register_fake
def _(T, rhs, u_eff, rg, j_eff, index, do_pivot=None, do_flip=None,
      enter=None, fcol=None, uf=None, u=None):
    R, N = T.shape
    return T.new_empty((R, N + 1))


def _vmap(info, in_dims, T, rhs, u_eff, rg, j_eff, index, do_pivot=None,
          do_flip=None, enter=None, fcol=None, uf=None, u=None):
    """Every batched operand with its lane axis first, the unbatched ones
    given a stride-0 lane axis: one launch for all lanes."""
    xs = (T, rhs, u_eff, rg, j_eff, index, do_pivot, do_flip, enter, fcol,
          uf, u)
    L = info.batch_size
    in_dims = tuple(in_dims) + (None,) * (len(xs) - len(in_dims))
    phys = []
    for x, d in zip(xs, in_dims):
        if isinstance(x, torch.Tensor):
            x = x.movedim(d, 0) if d is not None else _lanes(x[None], L)
        phys.append(x)
    T, rhs, u_eff, rg, j_eff, index, do_pivot, *f = phys
    flip = None if f[0] is None else Flip(*f)
    if on_cpu(T):
        # the plain version lane by lane (the wrapper itself never takes
        # the op on the CPU)
        return torch.stack([_reference_frame(
            T[k], rhs[k], u_eff[k], rg[k], j_eff[k], index,
            None if do_pivot is None else do_pivot[k],
            None if flip is None else Flip(*(x[k] for x in flip)))
            for k in range(L)]), 0
    return _launch(T, rhs, u_eff, rg, j_eff, index, do_pivot, flip,
                   True), 0


shard_pivot_op.register_vmap(_vmap)


def shard_vectors(row0, row1, bvec, w, vrow, vrow_rhs):
    """``shard_vectors_reference``'s (row0, row1, bvec): its plain version
    on CPU tensors, one launch on CUDA tensors (the three results are
    views of one buffer)."""
    if on_cpu(row0, row1, bvec, w, vrow, vrow_rhs):
        return shard_vectors_reference(row0, row1, bvec, w, vrow, vrow_rhs)
    n, M = vrow.shape[0], w.shape[0]
    xs = [w, vrow, vrow_rhs, row0, row1, bvec]
    shapes = [(M,), (n,), (), (n,), (n,), (M,)]
    dtype, dev = row0.dtype, row0.device
    for k, (x, shape) in enumerate(zip(xs, shapes)):
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"shard_vectors: operand {k} is {x.dtype} "
                             f"{tuple(x.shape)}, expected {dtype} {shape}")
        if not x.is_contiguous():
            xs[k] = x.contiguous()
    out = torch.empty((2 * n + M,), dtype=dtype, device=dev)
    args = array.array("q", [x.data_ptr() for x in xs]
                       + [out.data_ptr(), n, M])
    lib = lib_for(dev)
    err = getattr(lib, f"tpulp_shard_vectors_{suffix(dtype)}")(
        args.buffer_info()[0], stream_of(dev))
    if err:
        raise_on(lib, err, "shard_vectors")
    LAUNCHES["shard_vectors"] += 1
    return out[:n], out[n:2 * n], out[2 * n:]

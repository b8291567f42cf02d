"""``fused_fma``: ``c + value * a * b`` with one rounding per element.

The pivots of the rank-1, rank-K and batched engines update their rows
with ``c + value * a * b``. tpulp's XLA fuses that into one fused
multiply-add, and so does torch's CPU ``addcmul`` (``fma(value * a, b,
c)``); CUDA's ``addcmul`` rounds the product first, so a walk on the card
would part from tpulp's. On a CUDA tensor this op launches the kernel of
``csrc/fma.cu``, one ``fma()`` per element of the broadcast shape, reading
each operand through its (broadcast) strides; on CPU tensors it runs its
plain version, ``torch.addcmul``. Under ``torch.func.vmap`` it goes
through ``fma_op``, a ``torch.library`` custom op with a fake and a vmap
rule, so a vmapped pivot step batches it into one launch without the
per-sample fallback; outside vmap it skips that op's dispatch, which
costs more host time than the launch itself.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .launch import LAUNCHES, lib_for, raise_on, stream_of, suffix

__all__ = ["fused_fma", "fma_op", "geometry", "MAX_RANK"]

MAX_RANK = 4  # broadcast ranks the kernel indexes
# the kernel's index: the rank-4 shape, then each operand's strides
_GEOM = ctypes.c_longlong * (4 * MAX_RANK)
_PLANS: dict = {}  # (shapes and strides of c, a, b) -> _plan's result
_MAX_PLANS = 1024
_is_batched = torch._C._functorch.is_batchedtensor


def _shape(c, a, b) -> tuple:
    """The broadcast shape of the three (plain integers: torch's own helper
    costs tens of microseconds a call on this hot path)."""
    rank = max(c.dim(), a.dim(), b.dim())
    out = []
    for d in range(rank):
        size = 1
        for x in (c, a, b):
            k = d - rank + x.dim()
            n = x.shape[k] if k >= 0 else 1
            if n != 1:
                if size not in (1, n):
                    raise ValueError(f"fused_fma: shapes {tuple(c.shape)}, "
                                     f"{tuple(a.shape)}, {tuple(b.shape)} "
                                     "do not broadcast")
                size = n
        out.append(size)
    return tuple(out)


def _check_operands(c, a, b):
    if len({c.device, a.device, b.device}) > 1:
        raise ValueError(f"fused_fma: tensors must all be on the CPU or on "
                         f"one CUDA device; got {c.device}, {a.device}, "
                         f"{b.device}")
    if not (c.dtype == a.dtype == b.dtype):
        raise ValueError(f"fused_fma: operands of one dtype, got {c.dtype}, "
                         f"{a.dtype}, {b.dtype}")


def geometry(shape, operands) -> tuple[list, list]:
    """The kernel's rank-4 index: the broadcast shape left-padded with 1s,
    and each operand's strides in elements (0 along a broadcast dimension),
    operand after operand."""
    dims = [1] * (MAX_RANK - len(shape)) + list(shape)
    strides = []
    for x in operands:
        lead = MAX_RANK - x.dim()
        strides += [0] * lead + [st if n != 1 else 0
                                 for n, st in zip(x.shape, x.stride())]
    return dims, strides


def fused_fma(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
              value: float = 1.0) -> torch.Tensor:
    """``c + value * a * b`` over the broadcast shape of the three, rounded
    once per element (``fma(value * a, b, c)``). Plain tensors go straight
    to ``addcmul`` (CPU) or the kernel (CUDA); a CUDA tensor under
    ``torch.func.vmap``, or a meta tensor, goes through ``fma_op``."""
    _check_operands(c, a, b)
    kind = c.device.type
    if kind == "cpu":
        return torch.addcmul(c, a, b, value=value)
    if kind == "cuda" and not (_is_batched(c) or _is_batched(a)
                               or _is_batched(b)):
        return _launch(c, a, b, value)
    return fma_op(c, a, b, value)


def _plan(c, a, b) -> tuple:
    """(shape, elements, the kernel's geometry array) of a launch, cached
    by the operands' shapes and strides: the engines call with the same
    few layouts every pivot, and building the plan costs more host time
    than the launch."""
    key = (c.shape, c.stride(), a.shape, a.stride(), b.shape, b.stride())
    plan = _PLANS.get(key)
    if plan is None:
        shape = _shape(c, a, b)
        if len(shape) > MAX_RANK:
            raise ValueError(f"fused_fma: rank {len(shape)} > {MAX_RANK}")
        dims, strides = geometry(shape, (c, a, b))
        if len(_PLANS) >= _MAX_PLANS:
            _PLANS.clear()
        plan = _PLANS[key] = (shape, math.prod(shape),
                              _GEOM(*dims, *strides))
    return plan


def _launch(c, a, b, value: float) -> torch.Tensor:
    """The kernel's launch on plain CUDA tensors of one device."""
    suffix(c.dtype)  # float32 or float64
    shape, n, geom = _plan(c, a, b)
    out = torch.empty(shape, dtype=c.dtype, device=c.device)
    if n == 0:
        return out
    lib = lib_for(c.device)
    fn = lib.tpulp_fma_f32 if c.dtype == torch.float32 else \
        lib.tpulp_fma_f64
    # the launch copies ``geom`` into the kernel's parameters before it
    # returns, so one array serves every launch of its plan
    err = fn(out.data_ptr(), c.data_ptr(), a.data_ptr(), b.data_ptr(),
             float(value), n, geom, stream_of(c.device))
    if err:
        raise_on(lib, err, "fma")
    LAUNCHES["fused_fma"] += 1
    return out


@torch.library.custom_op("tpulp_torch::fma", mutates_args=())
def fma_op(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
           value: float = 1.0) -> torch.Tensor:
    """``fused_fma`` as a ``torch.library`` op, with a fake and a vmap
    rule: the form ``torch.func.vmap`` batches into one launch."""
    return fused_fma(c, a, b, value)


@fma_op.register_fake
def _(c, a, b, value=1.0):
    _check_operands(c, a, b)
    return torch.empty(_shape(c, a, b), dtype=c.dtype, device=c.device)


def _vmap(info, in_dims, c, a, b, value=1.0):
    """Batch dimension first on every batched operand, the unbatched ones
    left-padded to the same logical rank: one launch for all lanes."""
    xs = (c, a, b)
    if all(d is None for d in in_dims):
        return fused_fma(c, a, b, value), None
    rank = max(x.dim() - (d is not None) for x, d in zip(xs, in_dims))
    phys = []
    for x, d in zip(xs, in_dims):
        if d is None:
            x = x.reshape((1,) * (rank + 1 - x.dim()) + tuple(x.shape))
        else:
            x = x.movedim(d, 0)
            x = x.reshape((x.shape[0],) + (1,) * (rank + 1 - x.dim())
                          + tuple(x.shape[1:]))
        phys.append(x)
    return fused_fma(*phys, value), 0


fma_op.register_vmap(_vmap)

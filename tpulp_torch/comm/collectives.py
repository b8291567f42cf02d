"""The collectives of the sharded drivers, over one axis of a DeviceMesh.

``MeshAxis.psum`` / ``pmin`` / ``pmax`` (all_reduce SUM / MIN / MAX) and
``all_gather`` act over a mesh axis, or over a tuple of axes that spans the
whole mesh in order (the ``(hosts, cols)`` layout, hosts major). They take
and return device tensors and never read a value on the host, so a pivot
that calls them runs without a host round trip; on the card NCCL orders
them after the kernels already queued on the current stream. They are
out of place, like ``lax.psum``. ``all_gather`` uses the list form of
``torch.distributed.all_gather``, which both NCCL and gloo take for every
dtype; bool tensors travel as uint8.

``MeshAxis`` resolves an axis once (its process group, this rank's shard
index, the shard count) and provides the collectives; the drivers keep
one for a whole solve.

``COUNTS`` counts every call by ``(kind, dtype, elements)``, where the
elements are those one rank contributes; ``shard/analysis.py`` reads it
to check the drivers' communication structure.

Under ``torch.func.vmap`` (the lane-sharded steps of
``shard/sharded_batch.py``) a collective goes through a ``torch.library``
op whose vmap rule runs ONE collective on the whole batched tensor: the
lanes of a rank share each call, and ``COUNTS`` counts that one call with
every lane's elements.
"""

from __future__ import annotations

from collections import Counter
from typing import Tuple, Union

import torch
import torch.distributed as dist

__all__ = ["COUNTS", "reset_counts", "MeshAxis", "axis_index", "axis_size"]

Axis = Union[str, Tuple[str, ...]]

COUNTS: Counter = Counter()


def reset_counts() -> None:
    COUNTS.clear()


def _names(axis: Axis) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def axis_size(mesh, axis: Axis) -> int:
    """Shards along ``axis`` (the product over a tuple of axes)."""
    size = 1
    for name in _names(axis):
        size *= mesh.size(list(mesh.mesh_dim_names).index(name))
    return size


def _flat_ranks(mesh, axis: Axis) -> list:
    names = _names(axis)
    if names != tuple(mesh.mesh_dim_names):
        raise ValueError(f"a tuple axis must name every axis of the mesh in "
                         f"order, {tuple(mesh.mesh_dim_names)}; got {names}")
    return [int(r) for r in mesh.mesh.flatten().tolist()]


def axis_index(mesh, axis: Axis) -> int:
    """This rank's shard index along ``axis``."""
    if isinstance(axis, str):
        return mesh.get_local_rank(axis)
    return _flat_ranks(mesh, axis).index(dist.get_rank())


def _group(mesh, axis: Axis):
    """The process group of ``axis``; a tuple axis spans the whole mesh,
    which must hold every process in rank order (``global_device_mesh``'s
    layout), so its group is the default one."""
    if isinstance(axis, str):
        return mesh.get_group(axis)
    if _flat_ranks(mesh, axis) != list(range(dist.get_world_size())):
        raise ValueError("a tuple axis needs a mesh over every process, in "
                         "rank order")
    return dist.group.WORLD


def _count(kind: str, x: torch.Tensor) -> None:
    COUNTS[(kind, str(x.dtype).replace("torch.", ""), x.numel())] += 1


_is_batched = torch._C._functorch.is_batchedtensor
_REDUCE_OPS = {"psum": dist.ReduceOp.SUM, "pmin": dist.ReduceOp.MIN,
               "pmax": dist.ReduceOp.MAX}
# the process groups of the resolved axes, by key: a torch.library op
# takes no group object, so the ops below name a group by its key
_GROUPS: list = []


def _group_key(group) -> int:
    for key, g in enumerate(_GROUPS):
        if g is group:
            return key
    _GROUPS.append(group)
    return len(_GROUPS) - 1


def _all_reduce(x: torch.Tensor, key: int, kind: str) -> torch.Tensor:
    _count(kind, x)
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=_REDUCE_OPS[kind], group=_GROUPS[key])
    return out


def _all_gather(x: torch.Tensor, key: int, size: int) -> torch.Tensor:
    _count("all_gather", x)
    send = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    parts = [torch.empty_like(send) for _ in range(size)]
    dist.all_gather(parts, send, group=_GROUPS[key])
    out = torch.stack(parts)
    return out.to(torch.bool) if x.dtype == torch.bool else out


@torch.library.custom_op("tpulp_torch::all_reduce", mutates_args=())
def all_reduce_op(x: torch.Tensor, key: int, kind: str) -> torch.Tensor:
    """An all_reduce (``kind`` psum / pmin / pmax) over group ``key``, as
    a ``torch.library`` op with a vmap rule."""
    return _all_reduce(x, key, kind)


@all_reduce_op.register_fake
def _(x, key, kind):
    return torch.empty_like(x)


def _all_reduce_vmap(info, in_dims, x, key, kind):
    # elementwise over the shards: the lanes ride along in place
    return _all_reduce(x, key, kind), in_dims[0]


all_reduce_op.register_vmap(_all_reduce_vmap)


@torch.library.custom_op("tpulp_torch::all_gather", mutates_args=())
def all_gather_op(x: torch.Tensor, key: int, size: int) -> torch.Tensor:
    """Every shard's ``x`` stacked in shard order over group ``key``, as a
    ``torch.library`` op with a vmap rule."""
    return _all_gather(x, key, size)


@all_gather_op.register_fake
def _(x, key, size):
    return x.new_empty((size,) + tuple(x.shape))


def _all_gather_vmap(info, in_dims, x, key, size):
    # lanes first, gathered behind the shard axis: (P, lanes, ...)
    d = in_dims[0]
    if d is None:
        return _all_gather(x, key, size), None
    return _all_gather(x.movedim(d, 0), key, size), 1


all_gather_op.register_vmap(_all_gather_vmap)


class MeshAxis:
    """One axis (or tuple of axes) of a mesh, resolved once."""

    def __init__(self, mesh, axis: Axis = "cols"):
        self.mesh = mesh
        self.axis = axis
        self.group = _group(mesh, axis)
        self.index = axis_index(mesh, axis)
        self.size = axis_size(mesh, axis)
        self.key = _group_key(self.group)

    def _reduce(self, x: torch.Tensor, kind: str) -> torch.Tensor:
        if _is_batched(x):
            return all_reduce_op(x, self.key, kind)
        return _all_reduce(x, self.key, kind)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the shards, on every shard."""
        return self._reduce(x, "psum")

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, "pmin")

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, "pmax")

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every shard's ``x`` stacked in shard order: ``(P, *x.shape)``."""
        if _is_batched(x):
            return all_gather_op(x, self.key, self.size)
        return _all_gather(x, self.key, self.size)


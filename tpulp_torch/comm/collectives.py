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


class MeshAxis:
    """One axis (or tuple of axes) of a mesh, resolved once."""

    def __init__(self, mesh, axis: Axis = "cols"):
        self.mesh = mesh
        self.axis = axis
        self.group = _group(mesh, axis)
        self.index = axis_index(mesh, axis)
        self.size = axis_size(mesh, axis)

    def _reduce(self, x: torch.Tensor, op, kind: str) -> torch.Tensor:
        _count(kind, x)
        out = x.clone()
        dist.all_reduce(out, op=op, group=self.group)
        return out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the shards, on every shard."""
        return self._reduce(x, dist.ReduceOp.SUM, "psum")

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MIN, "pmin")

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MAX, "pmax")

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every shard's ``x`` stacked in shard order: ``(P, *x.shape)``."""
        _count("all_gather", x)
        send = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
        parts = [torch.empty_like(send) for _ in range(self.size)]
        dist.all_gather(parts, send, group=self.group)
        out = torch.stack(parts)
        return out.to(torch.bool) if x.dtype == torch.bool else out


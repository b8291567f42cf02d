"""Multi-process bring-up: ``torch.distributed`` initialisation and meshes.

The counterpart of ``tpulp.comm.distributed``. JAX's ``shard_map`` is
single-controller; torch.distributed is multi-controller: every process
(one per device) runs the same program on its own shard and meets the
others in collectives. This module wraps the three things such a run
needs:

1. ``init_distributed()`` brings the process group up. Its arguments
   resolve as explicit arguments, then ``TPULP_COORDINATOR`` /
   ``TPULP_NUM_PROCESSES`` / ``TPULP_PROCESS_ID``, then torchrun's
   ``MASTER_ADDR`` (+ ``MASTER_PORT``) / ``WORLD_SIZE`` / ``RANK``. NCCL on
   ``cuda``, gloo on ``cpu``. Idempotent while the group is up, and a
   no-op on one process with nothing configured.
2. ``global_device_mesh()`` is a ``DeviceMesh`` over every process: across
   nodes (``LOCAL_WORLD_SIZE`` below the world size) a 2-D ``("hosts",
   "cols")`` mesh with the hosts outermost, so that the column collectives
   of the sharded drivers stay inside a node; otherwise 1-D ``("cols",)``.
3. ``process_local_lanes()`` names the shards of an axis this process owns
   (the loading window for column-partitioned data).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

__all__ = [
    "init_distributed",
    "is_distributed",
    "global_device_mesh",
    "process_local_lanes",
]

_initialized = False


def is_distributed() -> bool:
    """True once a process group is up (brought up here or elsewhere)."""
    return _initialized or (dist.is_available() and dist.is_initialized())


def _address(coordinator_address: Optional[str]) -> Optional[str]:
    """``host:port``, from the argument, TPULP_COORDINATOR or torchrun's
    MASTER_ADDR / MASTER_PORT."""
    if coordinator_address is None:
        coordinator_address = os.environ.get("TPULP_COORDINATOR")
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    return coordinator_address


def _env_int(*names) -> Optional[int]:
    for name in names:
        if name in os.environ:
            return int(os.environ[name])
    return None


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device: str = "cuda") -> int:
    """Bring up the default process group; returns this process's rank (0
    on a single-process run with nothing configured, which starts no
    group). Arguments resolve as the module doc says. On ``cuda`` the
    process takes the card ``LOCAL_RANK`` (else its rank modulo the cards
    it sees) as its current device."""
    global _initialized
    if dist.is_initialized():
        _initialized = True
        return dist.get_rank()
    coordinator_address = _address(coordinator_address)
    if num_processes is None:
        num_processes = _env_int("TPULP_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("TPULP_PROCESS_ID", "RANK")
    if coordinator_address is None and num_processes in (None, 1):
        # one process and nothing configured: nothing to bring up
        _initialized = True
        return 0
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "init_distributed needs a coordinator address, the number of "
            f"processes and this process's id; got {coordinator_address!r}, "
            f"{num_processes!r}, {process_id!r}")
    kind = torch.device(device).type
    kw = {}
    if kind == "cuda":
        local = _env_int("LOCAL_RANK")
        index = local if local is not None \
            else process_id % torch.cuda.device_count()
        torch.cuda.set_device(index)
        kw["device_id"] = torch.device("cuda", index)
    dist.init_process_group(
        "nccl" if kind == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id), **kw)
    _initialized = True
    return dist.get_rank()


def global_device_mesh(axis: str = "cols", dcn_axis: str = "hosts",
                       device: Optional[str] = None):
    """A ``DeviceMesh`` over every process of the group: ``(hosts, cols)``
    with the hosts outermost when the processes span nodes
    (``LOCAL_WORLD_SIZE`` below the world size), else ``(cols,)``. The
    device type defaults to the group's backend (NCCL: ``cuda``)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("global_device_mesh needs a process group: call "
                           "init_distributed first")
    if device is None:
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    world = dist.get_world_size()
    local = _env_int("LOCAL_WORLD_SIZE") or world
    if local < world:
        if world % local:
            raise ValueError(f"world size {world} is no multiple of "
                             f"LOCAL_WORLD_SIZE {local}")
        return init_device_mesh(device, (world // local, local),
                                mesh_dim_names=(dcn_axis, axis))
    return init_device_mesh(device, (world,), mesh_dim_names=(axis,))


def process_local_lanes(mesh, axis: str = "cols") -> Tuple[int, int]:
    """(start, stop) shard indices of ``axis`` held by this process: one
    shard, since each process holds one device of the mesh."""
    me = dist.get_rank()
    dim = list(mesh.mesh_dim_names).index(axis)
    mine = sorted({int(idx[dim]) for idx in
                   (mesh.mesh == me).nonzero().tolist()})
    if not mine:
        return (0, 0)
    return (mine[0], mine[-1] + 1)

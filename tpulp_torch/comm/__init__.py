"""Multi-process bring-up and the collectives of the sharded drivers."""

from .collectives import (COUNTS, MeshAxis, axis_index, axis_size,
                          reset_counts)
from .distributed import (global_device_mesh, init_distributed,
                          is_distributed, process_local_lanes)

__all__ = [
    "init_distributed",
    "is_distributed",
    "global_device_mesh",
    "process_local_lanes",
    "MeshAxis",
    "axis_index",
    "axis_size",
    "COUNTS",
    "reset_counts",
]

"""The port's CUDA kernels, their plain versions and launch counts."""

from .block import (blocked_inner_block, blocked_inner_block_reference,
                    fused_flush, fused_flush_reference, inner_block_plan)
from .blocked import blocked_stage, blocked_steps
from .blocked_cluster import blocked_cluster_plan
# the module, not its wrapper of the same name: blocked_grid.blocked_grid
from .blocked_grid import blocked_grid_plan
# the module, not its wrapper of the same name: bounded_grid.bounded_grid
from .bounded_grid import bounded_grid_plan
from .fma import fused_fma
from .lanes import (lane_bounded, lane_bounded_plan, lane_dual, lane_dual_plan,
                    lane_plan, lane_primal)
from .launch import LAUNCHES, reset_launches
from .rank1 import rank1_stage, rank1_steps
# the module, not its wrapper of the same name: rank1_cluster.rank1_cluster
from .rank1_cluster import cluster_plan
# the module, not its wrapper of the same name: rank1_grid.rank1_grid
from .rank1_grid import rank1_grid_plan
# the module, not its wrapper of the same name: shard_pivot.shard_pivot
from .shard_pivot import shard_pivot_plan, shard_vectors

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "fused_flush",
    "fused_flush_reference",
    "blocked_inner_block",
    "blocked_inner_block_reference",
    "inner_block_plan",
    "fused_fma",
    "lane_dual",
    "lane_primal",
    "lane_plan",
    "lane_dual_plan",
    "lane_bounded",
    "lane_bounded_plan",
    "bounded_grid_plan",
    "rank1_steps",
    "rank1_stage",
    "cluster_plan",
    "rank1_grid_plan",
    "blocked_steps",
    "blocked_stage",
    "blocked_cluster_plan",
    "blocked_grid_plan",
    "shard_pivot_plan",
    "shard_vectors",
]

"""The plain versions' sums, taken in the kernels' order.

A kernel adds a block's values thread by thread (thread t adds x[t],
x[t + threads], ... in turn), then the warp's 32 by the shuffle tree
(distance 16, 8, 4, 2, 1), then the warps' sums by the same tree, padded
with zeros to 32 (common.cuh's ``block_reduce``, grid.cuh's
``key_reduce``). Across blocks a cluster adds the blocks' sums in rank
order (``slab_sum``); a grid adds them as one warp does, lane l the sums
of blocks l, l + 32, ... in turn, then the shuffle tree (``grid_sum``,
grid.cuh's mailbox combines). The sums feed finiteness checks only, so
the plain versions take them in this order to part from the kernels
nowhere, not even where one order overflows and another does not.
"""

from __future__ import annotations

import torch

__all__ = ["block_sums", "slab_sum", "block_sum", "grid_sum"]

_WARP = 32
# threads a block of the cluster and grid walks
THREADS = 512


def _tree(v: torch.Tensor) -> torch.Tensor:
    """The shuffle tree over the last axis (32 entries)."""
    span = _WARP
    while span > 1:
        span //= 2
        v = v[..., :span] + v[..., span:2 * span]
    return v[..., 0]


def block_sums(x: torch.Tensor, width: int, blocks: int,
               threads: int = THREADS) -> torch.Tensor:
    """The (blocks,) sums of the 1-d ``x``'s slabs as ``blocks`` blocks of
    ``threads`` threads take them: block b's slab ``x[b width:(b + 1)
    width]`` (zeros past ``x``), thread t adding its entries t, t +
    threads, ... in turn, then the warp tree, then the same tree over the
    warps' sums (all blocks at once)."""
    rounds = max(1, -(-width // threads))
    flat = x.new_zeros((blocks * width,))
    flat[:x.numel()] = x
    slabs = x.new_zeros((blocks, rounds * threads))
    slabs[:, :width] = flat.view(blocks, width)
    acc = x.new_zeros((blocks, threads))
    for r in range(rounds):
        acc = acc + slabs[:, r * threads:(r + 1) * threads]
    warps = x.new_zeros((blocks, _WARP))
    warps[:, :threads // _WARP] = _tree(acc.view(blocks, threads // _WARP,
                                                 _WARP))
    return _tree(warps)


def slab_sum(x: torch.Tensor, width: int, blocks: int,
             threads: int = THREADS) -> torch.Tensor:
    """The sum of the 1-d ``x`` as a cluster of ``blocks`` blocks takes it:
    each block's slab (``block_sums``), then the blocks' sums added in rank
    order."""
    sums = block_sums(x, width, blocks, threads)
    total = sums[0]
    for b in range(1, blocks):
        total = total + sums[b]
    return total


def block_sum(x: torch.Tensor, threads: int = THREADS) -> torch.Tensor:
    """The sum of the 1-d ``x`` as one block takes it."""
    return block_sums(x, x.numel(), 1, threads)[0]


def grid_sum(x: torch.Tensor, width: int, blocks: int,
             threads: int = THREADS) -> torch.Tensor:
    """The sum of the 1-d ``x`` as a grid takes it: each block's slab of
    ``width`` entries (``block_sums``); then lane l of a warp adds the sums
    of blocks l, l + 32, l + 64, ... in turn, and the shuffle tree adds the
    lanes."""
    parts = block_sums(x, width, blocks, threads)
    rounds = -(-blocks // _WARP)
    padded = parts.new_zeros((rounds * _WARP,))
    padded[:blocks] = parts
    lanes = parts.new_zeros((_WARP,))
    for r in range(rounds):
        lanes = lanes + padded[r * _WARP:(r + 1) * _WARP]
    return _tree(lanes)

"""The raster kernels' work list (K2, K3, K4): which tiles are split across
blocks, and in which order the tiles are taken.

A pixel's recurrence over its tile's pairs is serial, so with one block per
tile the longest walk of a frame is one block's work while the other SMs
drain.  The kernels therefore split a heavy tile by pixels across
``_split(ppt)`` blocks (``csrc/raster_common.cuh::work_of``), take the heavy
tiles first and the light ones after them, longest first.

On the card the list is built by one small kernel
(``csrc/raster_common.cuh::raster_plan_kernel``) that each of the three C
entry points launches in its own stream just before its kernel, without a
host sync, from a per-tile planning quantity: the pairs the tile will walk
(K4: what the forward's cut left), or an upper bound of them where the walk
is not known before the launch (K2's exit and K3's cut end a walk early).
:func:`_tile_plan` is that kernel's plain version, and this module holds
the constants the wrappers hand to it.
"""

from __future__ import annotations

import torch

# the kernels' block size
THREADS = 256
# a tile is split across min(PPT, SPLIT_BLOCKS) blocks, by pixels, where it
# walks more than SPLIT_MIN_PAIRS pairs and more than the frame's walk
# spread over BLOCKS_PER_SM blocks an SM
SPLIT_MIN_PAIRS = 4096
SPLIT_BLOCKS = 4
BLOCKS_PER_SM = 2
# the plan kernel orders tiles by a counting sort over this many buckets of
# walk length (csrc/raster_common.cuh's PLAN_BUCKETS)
PLAN_BUCKETS = 1024


def _split(ppt: int) -> int:
    """Blocks per heavy tile: each keeps at least one pixel a thread."""
    return min(ppt, SPLIT_BLOCKS)


def _plan_keys(walk, split: int, slots: int):
    """Each tile's sort key in the work list.  A tile is heavy (split)
    where it walks more than SPLIT_MIN_PAIRS pairs and more than
    ``walk.sum() // slots``, the mean load of ``slots`` resident blocks:
    unsplit, it would outlast the rest of the grid.  A balanced frame
    splits nothing.  Heavy tiles take the keys below PLAN_BUCKETS, light
    ones those from PLAN_BUCKETS on; within each group the key grows with
    the bucket ``(max - walk) * (PLAN_BUCKETS - 1) // max`` of the tile's
    walk (longest first, to within a bucket).  A negative walk counts as
    0."""
    walk = torch.clamp(walk.to(torch.int64), min=0)
    wmax = walk.max()
    bucket = (wmax - walk) * (PLAN_BUCKETS - 1) // torch.clamp(wmax, min=1)
    if split > 1:
        cap = torch.clamp(walk.sum() // slots, min=SPLIT_MIN_PAIRS)
        heavy = walk > cap
    else:
        heavy = torch.zeros_like(walk, dtype=torch.bool)
    return torch.where(heavy, bucket, PLAN_BUCKETS + bucket)


def _tile_plan(walk, split: int, slots: int):
    """Plain version of the plan kernel (``raster_plan_kernel``): tile ids
    by :func:`_plan_keys` (int32) and how many of them are split (a (1,)
    int32 count).  The kernel leaves the order inside a bucket to its
    atomics; here it is by tile id."""
    key = _plan_keys(walk, split, slots)
    order = torch.argsort(key, stable=True).to(torch.int32)
    return order, (key < PLAN_BUCKETS).sum(dtype=torch.int32).reshape(1)


def _slots(dev) -> int:
    """Blocks the card holds at once, as the plan counts them."""
    return BLOCKS_PER_SM * torch.cuda.get_device_properties(
        dev).multi_processor_count


def _block_work(order, nheavy, split: int):
    """(tile, group, groups) of every block of a launch of
    num_tiles * split blocks, as the kernels' work_of() assigns them:
    group g of a tile holds its pixel slots [g, g + 1) * THREADS * PPT /
    groups; blocks past the list take no tile."""
    nt, nh = order.numel(), int(nheavy)
    work = []
    for b in range(nt * split):
        q, r = divmod(b, split)
        if q < nh:
            work.append((int(order[q]), r, split))
        elif nh + (q - nh) * split + r < nt:
            work.append((int(order[nh + (q - nh) * split + r]), 0, 1))
    return work

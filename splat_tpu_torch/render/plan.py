"""The raster kernels' work list (K2, K3, K4): which tiles are split across
blocks, and in which order the tiles are taken; for K2, which tiles are cut
into depth segments.

A pixel's recurrence over its tile's pairs is serial, so with one block per
tile the longest walk of a frame is one block's work while the other SMs
drain.  The kernels therefore split a heavy tile by pixels across
``_split(ppt)`` blocks (``csrc/raster_common.cuh::work_of``), take the heavy
tiles first and the light ones after them, longest first.  That split
leaves a heavy tile's walk as long as the tile, and a light tile walked by
one block at several pixels a thread is slower a pair still: in a frame
with heavy tiles K2 also cuts every long tile by depth into segments
(:func:`_segments`), each walked by a cluster of its own and merged front
to back (``csrc/raster.cu``).

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
# K2 cuts a tile into depth segments of cap // SEG_DIV pairs, rounded up to
# a multiple of chunk (cap: the plan's heavy-tile threshold), in a frame
# that has heavy tiles: a heavy tile where it holds more than two
# segments' worth of pairs, a light one where it holds more than a
# LIGHT_DIV-th of a segment's.  Swept on an H100 at the surface-3m orbit's
# frames (K2 ms a frame at five poses, mean): SEG_DIV 2: 2.70, 4: 2.33,
# 6: 2.22, 8: 2.18, 12: 2.18, 16: 2.23; LIGHT_DIV 4, 8, 16 at SEG_DIV 8:
# 2.17, 2.18, 2.18 (the unsegmented kernel: 4.45)
SEG_DIV = 8
LIGHT_DIV = 8
# a tile is cut into fewer segments than this (csrc/raster_common.cuh's
# SEG_ROUNDS), or none is cut
SEG_ROUNDS = 1024


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


def _segment_len(cap: int, chunk: int) -> int:
    """K2's segment length for the plan's ``cap``: ``cap // SEG_DIV``
    rounded up to a multiple of ``chunk``."""
    return -(-max(cap // SEG_DIV, 1) // chunk) * chunk


def _segments(start, end, split: int, slots: int, chunk: int):
    """Plain version of K2's depth segments (``raster_common.cuh``'s
    ``plan_segments``): the segment length L and each tile's segments,
    (T,) int64, 0 for a tile walked whole.  Only a frame with heavy tiles
    (as :func:`_plan_keys` decides) is cut: a heavy tile of more than 2 * L
    pairs, and a light one of more than L // LIGHT_DIV, takes
    ceil((end - base) / L) segments, base being its start rounded down to
    a multiple of ``chunk``; segment j holds its pairs [base + j * L,
    base + (j + 1) * L)."""
    s, e = start.to(torch.int64), end.to(torch.int64)
    walk = torch.clamp(e - s, min=0)
    cap = max(SPLIT_MIN_PAIRS, int(walk.sum()) // slots)
    seg = _segment_len(cap, chunk)
    heavy = _plan_keys(walk, split, slots) < PLAN_BUCKETS
    over = torch.where(heavy, 2 * seg, max(seg // LIGHT_DIV, 1))
    base = s - s % chunk
    # a frame without heavy tiles is left whole: cut as the rule cuts the
    # others, the random-1m orbit's frames (no tile above 5.8k pairs, L =
    # 1024) took ~2,580 segments and K2 0.50 -> 0.73 ms on an H100 (four
    # poses of the cell's orbit)
    cut = (e - s > over) & bool(heavy.any())
    return seg, torch.where(cut, -((base - e) // seg), torch.zeros_like(s))


def _k2_capacity(num_tiles: int, ppt: int, groups: int, slots: int,
                 segments: bool) -> tuple[int, int]:
    """(clusters, segments): the clusters of heavy tiles and segments, and
    the segments' (C, T) scratch slots, that K2's work list is sized for.
    Fewer than ``slots`` tiles are heavy, each over the frame's pairs /
    slots; a cut tile takes fewer than pairs / L + 2 segments, with L at
    least about cap / SEG_DIV >= pairs / (SEG_DIV * slots): fewer than
    (SEG_DIV + 1) * slots + 2 * num_tiles in all (the tiles' term is the
    tighter of the two: the cut light tiles alone may number up to
    LIGHT_DIV * SEG_DIV * slots).  The plan cuts no tile of a frame whose
    segments would not fit, so this is the worst frame's size: 6,456
    slots of 16 KB at 1080p on an H100, which each captured frame's graph
    pool holds (measured: 719 -> 826 MB a key at the surface-3m orbit,
    325 -> 432 MB at the random-1m one).  None where a tile takes several
    blocks (``groups`` > 1) or one block takes a heavy tile whole."""
    if groups > 1 or _split(ppt) == 1:
        return 0, 0
    segs = (SEG_DIV + 1) * slots + 2 * num_tiles if segments else 0
    return min(num_tiles, slots) + segs, segs

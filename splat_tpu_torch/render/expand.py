"""Pair expansion: per-gaussian tile spans -> per-slot sort keys (K1).

Port of ``splat_tpu/render/expand.py::expand_pair_keys``.  For each slot
k < k_cap: the owner g with first_slot[g] <= k < first_slot[g + 1], the
within-span index r = k - first_slot[g], the tile
(ty0 + r // sw) * ntx + tx0 + r % sw, and the int64 key
(tile << 32) | f32 bits of the owner's depth; slots from min(total, k_cap)
on get the sentinel key ``num_tiles << 32`` and owner 0.

With ``cull`` (``binning.cull_rows``: per gaussian cx, cy, lam, thresh) a
slot whose tile's nearest pixel lies (dx, dy) from the owner's centre,
with ``(dx*dx + dy*dy) * lam > thresh`` in f32, is dead: it gets the
sentinel key and owner 0 as well, and sorts after every walked pair.  The
tile's pixels are the integers [tx * tile_w, (tx + 1) * tile_w - 1] (and
likewise in y), as the raster kernel places them; dx is rounded as the
raster kernel rounds px - cx.

The card runs the hand-written kernel ``csrc/expand.cu`` (a block takes
1,024 consecutive slots, finds the owners of its first and last slot and
searches the others in a copy of that range in shared memory); CPU tensors
take :func:`expand_pair_keys_plain`, which computes the same integers.  The TPU
version's byte-split one-hot matmul, 24-bit depth quantization and fake
slots for invisible gaussians exist only for the TPU and are gone.
"""

from __future__ import annotations

import torch

from splat_tpu_torch import _build


def _check_cull(cull, tile_wh) -> None:
    if cull is not None and tile_wh is None:
        raise ValueError("expand_pair_keys: cull needs the tile size tile_wh")


def cull_dead(cull, owner, tile_x, tile_y, tile_wh):
    """Which slots the cull drops: (M,) bool for the slots' owners and
    tile coordinates (int64), as ``csrc/expand.cu::cull_dead`` decides."""
    c = cull[owner]
    cx, cy, lam, thresh = c[:, 0], c[:, 1], c[:, 2], c[:, 3]
    tw, th = tile_wh
    xa = (tile_x * tw).to(torch.float32)
    ya = (tile_y * th).to(torch.float32)
    zero = torch.zeros_like(cx)
    ddx = torch.maximum(torch.maximum(xa - cx, cx - (xa + (tw - 1))), zero)
    ddy = torch.maximum(torch.maximum(ya - cy, cy - (ya + (th - 1))), zero)
    return (ddx * ddx + ddy * ddy) * lam > thresh


def expand_pair_keys_plain(first_slot, tx0, ty0, span_w, depth_bits, total,
                           *, k_cap: int, ntx: int, num_tiles: int,
                           cull=None, tile_wh=None):
    """Plain PyTorch version of the K1 kernel (any device)."""
    _check_cull(cull, tile_wh)
    n = first_slot.shape[0]
    dev = first_slot.device
    counts = torch.cat([first_slot[1:], total.reshape(1)]) - first_slot
    owner = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int64, device=dev), counts)[:k_cap]
    m = owner.shape[0]
    r = torch.arange(m, dtype=torch.int64, device=dev) - first_slot[owner]
    sw = span_w[owner].to(torch.int64)
    dy = torch.div(r, sw, rounding_mode="floor")
    dx = r - dy * sw
    tile_x = tx0[owner].to(torch.int64) + dx
    tile_y = ty0[owner].to(torch.int64) + dy
    tile = tile_y * ntx + tile_x
    low = depth_bits[owner].to(torch.int64) & 0xFFFFFFFF
    key = (tile << 32) | low
    if cull is not None:
        dead = cull_dead(cull, owner, tile_x, tile_y, tile_wh)
        key = torch.where(dead, num_tiles << 32, key)
        owner = torch.where(dead, 0, owner)
    keys = torch.full((k_cap,), num_tiles << 32, dtype=torch.int64,
                      device=dev)
    owners = torch.zeros((k_cap,), dtype=torch.int64, device=dev)
    keys[:m] = key
    owners[:m] = owner
    return keys, owners


def expand_pair_keys(first_slot, tx0, ty0, span_w, depth_bits, total, *,
                     k_cap: int, ntx: int, num_tiles: int, cull=None,
                     tile_wh=None):
    """(N,) spans -> ((k_cap,) int64 keys, (k_cap,) int64 owners).

    first_slot: (N,) int64 exclusive prefix sum of per-gaussian tile counts.
    tx0 / ty0 / span_w: (N,) int32 tile-rect origin and width.
    depth_bits: (N,) int32 bits of each gaussian's f32 view depth.
    total: (1,) int64 true pair count (stays on the device: no host sync).
    cull: None, or (N, 4) f32 ``binning.cull_rows``: drop the dead pairs of
      tiles of ``tile_wh`` = (width, height) pixels (required with cull).

    CUDA tensors launch ``csrc/expand.cu`` (or raise); CPU tensors take
    :func:`expand_pair_keys_plain`.
    """
    dev = first_slot.device
    _check_cull(cull, tile_wh)
    if dev.type == "cpu":
        return expand_pair_keys_plain(first_slot, tx0, ty0, span_w,
                                      depth_bits, total, k_cap=k_cap,
                                      ntx=ntx, num_tiles=num_tiles,
                                      cull=cull, tile_wh=tile_wh)
    if dev.type != "cuda":
        raise ValueError(f"expand_pair_keys: unsupported device {dev}")
    n = first_slot.shape[0]
    _build.check_tensor(first_slot, "first_slot", torch.int64, (n,), dev)
    for name, t in (("tx0", tx0), ("ty0", ty0), ("span_w", span_w),
                    ("depth_bits", depth_bits)):
        _build.check_tensor(t, name, torch.int32, (n,), dev)
    _build.check_tensor(total, "total", torch.int64, (1,), dev)
    if cull is not None:
        _build.check_tensor(cull, "cull", torch.float32, (n, 4), dev)
    if num_tiles >= 1 << 31:
        raise ValueError(f"num_tiles {num_tiles} does not fit the key")
    keys = torch.empty((k_cap,), dtype=torch.int64, device=dev)
    owners = torch.empty((k_cap,), dtype=torch.int64, device=dev)
    if k_cap == 0:
        return keys, owners
    fn = _build.library().splat_expand_pairs
    tw, th = tile_wh or (0, 0)        # read only with the cull
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(first_slot.data_ptr(), tx0.data_ptr(), ty0.data_ptr(),
                 span_w.data_ptr(), depth_bits.data_ptr(), total.data_ptr(),
                 None if cull is None else cull.data_ptr(), n, k_cap, ntx,
                 num_tiles, tw, th, keys.data_ptr(),
                 owners.data_ptr(), stream)
    _build.check(err, "expand_pair_keys")
    expand_pair_keys.launches += 1
    if cull is not None:
        expand_pair_keys.cull_launches += 1
    return keys, owners


expand_pair_keys.launches = 0
# of those, the launches of the cull variant
expand_pair_keys.cull_launches = 0

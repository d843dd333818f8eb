"""Pair expansion: per-gaussian tile spans -> per-slot sort keys (K1).

Port of ``splat_tpu/render/expand.py::expand_pair_keys``.  For each slot
k < k_cap: the owner g with first_slot[g] <= k < first_slot[g + 1], the
within-span index r = k - first_slot[g], the tile
(ty0 + r // sw) * ntx + tx0 + r % sw, and the int64 key
(tile << 32) | f32 bits of the owner's depth; slots from min(total, k_cap)
on get the sentinel key ``num_tiles << 32`` and owner 0.

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


def expand_pair_keys_plain(first_slot, tx0, ty0, span_w, depth_bits, total,
                           *, k_cap: int, ntx: int, num_tiles: int):
    """Plain PyTorch version of the K1 kernel (any device)."""
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
    tile = (ty0[owner].to(torch.int64) + dy) * ntx + tx0[owner] + dx
    low = depth_bits[owner].to(torch.int64) & 0xFFFFFFFF
    keys = torch.full((k_cap,), num_tiles << 32, dtype=torch.int64,
                      device=dev)
    owners = torch.zeros((k_cap,), dtype=torch.int64, device=dev)
    keys[:m] = (tile << 32) | low
    owners[:m] = owner
    return keys, owners


def expand_pair_keys(first_slot, tx0, ty0, span_w, depth_bits, total, *,
                     k_cap: int, ntx: int, num_tiles: int):
    """(N,) spans -> ((k_cap,) int64 keys, (k_cap,) int64 owners).

    first_slot: (N,) int64 exclusive prefix sum of per-gaussian tile counts.
    tx0 / ty0 / span_w: (N,) int32 tile-rect origin and width.
    depth_bits: (N,) int32 bits of each gaussian's f32 view depth.
    total: (1,) int64 true pair count (stays on the device: no host sync).

    CUDA tensors launch ``csrc/expand.cu`` (or raise); CPU tensors take
    :func:`expand_pair_keys_plain`.
    """
    dev = first_slot.device
    if dev.type == "cpu":
        return expand_pair_keys_plain(first_slot, tx0, ty0, span_w,
                                      depth_bits, total, k_cap=k_cap,
                                      ntx=ntx, num_tiles=num_tiles)
    if dev.type != "cuda":
        raise ValueError(f"expand_pair_keys: unsupported device {dev}")
    n = first_slot.shape[0]
    _build.check_tensor(first_slot, "first_slot", torch.int64, (n,), dev)
    for name, t in (("tx0", tx0), ("ty0", ty0), ("span_w", span_w),
                    ("depth_bits", depth_bits)):
        _build.check_tensor(t, name, torch.int32, (n,), dev)
    _build.check_tensor(total, "total", torch.int64, (1,), dev)
    if num_tiles >= 1 << 31:
        raise ValueError(f"num_tiles {num_tiles} does not fit the key")
    keys = torch.empty((k_cap,), dtype=torch.int64, device=dev)
    owners = torch.empty((k_cap,), dtype=torch.int64, device=dev)
    if k_cap == 0:
        return keys, owners
    fn = _build.library().splat_expand_pairs
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(first_slot.data_ptr(), tx0.data_ptr(), ty0.data_ptr(),
                 span_w.data_ptr(), depth_bits.data_ptr(), total.data_ptr(),
                 n, k_cap, ntx, num_tiles, keys.data_ptr(),
                 owners.data_ptr(), stream)
    _build.check(err, "expand_pair_keys")
    expand_pair_keys.launches += 1
    return keys, owners


expand_pair_keys.launches = 0

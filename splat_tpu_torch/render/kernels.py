"""Per-tile front-to-back alpha compositing (K2).

Port of ``splat_tpu/render/kernels.py::rasterize_tiles``.  Each tile walks
its sorted pair range [start, end) front to back.  For each (pixel, pair):
dx = px - cx, dy = cy - py (integer pixel coordinates, local +y up),
power = a2*dx^2 + c2*dy^2 + b2*dx*dy, alpha = min(alpha_clamp,
op*exp(power)); the pair is kept if alpha >= alpha_min and, unless
sigma_cutoff is inf, the pixel is inside the quantized bbox.  Kept pairs
composite C += alpha*T*color, T *= 1 - alpha.  After each batch of
``chunk`` pairs (batches start at absolute multiples of ``chunk`` in the
sorted array) the whole tile stops once every one of its pixels has
T < alpha_min.  Output: clip(C + T*background) plus clip(1 - T) with
alpha_channel, as (H, W, C).

The card runs the hand-written kernel ``csrc/raster.cu``; CPU tensors take
:func:`rasterize_tiles_plain`, which performs the same float operations in
the same order, so the two differ only where the libraries' rounding does.
The TPU kernel's prefix-product/MXU machinery and its phase compaction
(``subtile_exit``) are not ported.
"""

from __future__ import annotations

import math

import torch

from splat_tpu_torch import _build
from splat_tpu_torch.config import RenderConfig
from splat_tpu_torch.render.binning import FEATURE_DIM, TileBins

THREADS = 256
# pixels per thread the kernel is instantiated for (tile <= 16 * 256 px)
_PPT = (1, 2, 4, 8, 16)
# the batch lives in the default 48 KB of shared memory
_MAX_CHUNK = (48 * 1024) // (4 * FEATURE_DIM)


def _untile(x, nty: int, ntx: int, th: int, tw: int, h: int, w: int):
    """(T, P, ...) per-tile pixels -> (H, W, ...) image."""
    rest = x.shape[2:]
    img = x.reshape(nty, ntx, th, tw, *rest).transpose(1, 2)
    return img.reshape(nty * th, ntx * tw, *rest)[:h, :w]


def rasterize_tiles_plain(bins: TileBins, h: int, w: int,
                          config: RenderConfig, *,
                          return_walked: bool = False):
    """Plain PyTorch version of the K2 kernel (any device): all tiles step
    through their batches together, each batch composited pair by pair.

    return_walked: also return the (T,) int64 number of pairs each tile
    walked before its exit (the work the kernel does on these inputs)."""
    tw, th = config.tile_w, config.tile_h
    ntx, nty = bins.tiles_x, bins.tiles_y
    nt, p, chunk = ntx * nty, tw * th, config.chunk
    feats = bins.features
    dev = feats.device
    kp = feats.shape[1]
    use_bbox = math.isfinite(config.sigma_cutoff)

    s = bins.tile_start.to(torch.int64)
    e = bins.tile_end.to(torch.int64)
    base = s - s % chunk
    nb = torch.where(e > base, (e - base + chunk - 1) // chunk,
                     torch.zeros_like(e))
    lin = torch.arange(p, device=dev)
    tid = torch.arange(nt, device=dev)
    pxf = ((tid % ntx)[:, None] * tw + lin % tw).to(torch.float32)  # (T, P)
    pyf = ((tid // ntx)[:, None] * th + lin // tw).to(torch.float32)
    color = torch.zeros((nt, p, 3), dtype=torch.float32, device=dev)
    trans = torch.ones((nt, p), dtype=torch.float32, device=dev)
    alive = torch.ones(nt, dtype=torch.bool, device=dev)
    batches = torch.zeros(nt, dtype=torch.int64, device=dev)
    lane = torch.arange(chunk, device=dev)

    for j in range(int(nb.max()) if nt else 0):
        act = torch.nonzero(alive & (nb > j)).flatten()
        if act.numel() == 0:
            break
        k = base[act, None] + j * chunk + lane               # (A, chunk)
        valid = (k >= s[act, None]) & (k < e[act, None])
        f = feats[:, k.clamp(0, max(kp - 1, 0))]             # (F, A, chunk)
        px, py = pxf[act], pyf[act]
        c_a, t_a = color[act], trans[act]
        for i in range(chunk):
            v = valid[:, i]
            if not bool(v.any()):
                continue
            cx, cy, a2, b2, c2, r, g, b, op, rx2, ry2 = (
                f[q, :, i, None] for q in range(FEATURE_DIM))
            dx = px - cx
            dy = cy - py
            dx2 = dx * dx
            dy2 = dy * dy
            power = a2 * dx2 + c2 * dy2 + b2 * (dx * dy)
            alpha = torch.clamp(op * torch.exp(power), max=config.alpha_clamp)
            keep = (alpha >= config.alpha_min) & v[:, None]
            if use_bbox:
                keep = keep & (dx2 <= rx2) & (dy2 <= ry2)
            wgt = (alpha * t_a)[..., None]
            rgb = torch.stack([r, g, b], dim=-1)              # (A, 1, 3)
            c_a = torch.where(keep[..., None], c_a + wgt * rgb, c_a)
            t_a = torch.where(keep, t_a * (1.0 - alpha), t_a)
        color[act] = c_a
        trans[act] = t_a
        alive[act] = t_a.amax(dim=1) >= config.alpha_min
        batches[act] = j + 1

    bg = torch.tensor(config.background, dtype=torch.float32, device=dev)
    out = [torch.clamp(color + trans[..., None] * bg, 0.0, 1.0)]
    if config.alpha_channel:
        out.append(torch.clamp(1.0 - trans, 0.0, 1.0)[..., None])
    img = _untile(torch.cat(out, dim=-1), nty, ntx, th, tw, h, w)
    if return_walked:
        walked = torch.clamp(torch.minimum(e, base + batches * chunk) - s,
                             min=0)
        return img, walked
    return img


def rasterize_tiles(bins: TileBins, h: int, w: int,
                    config: RenderConfig) -> torch.Tensor:
    """Composite the binned pairs.  Returns float32 (H, W, 3) in [0, 1], or
    (H, W, 4) with config.alpha_channel (RGB + accumulated 1 - T).

    CUDA tensors launch ``csrc/raster.cu`` (or raise); CPU tensors take
    :func:`rasterize_tiles_plain`.
    """
    feats = bins.features
    dev = feats.device
    if dev.type == "cpu":
        return rasterize_tiles_plain(bins, h, w, config)
    if dev.type != "cuda":
        raise ValueError(f"rasterize_tiles: unsupported device {dev}")
    tw, th = config.tile_w, config.tile_h
    nt = bins.tiles_x * bins.tiles_y
    p = tw * th
    ppt = next((q for q in _PPT if q * THREADS >= p), None)
    if ppt is None:
        raise ValueError(f"tile of {p} pixels exceeds the kernel's "
                         f"{_PPT[-1] * THREADS}")
    if not 1 <= config.chunk <= _MAX_CHUNK:
        raise ValueError(f"chunk {config.chunk} outside [1, {_MAX_CHUNK}]")
    if bins.tiles_x * tw < w or bins.tiles_y * th < h:
        raise ValueError("tile grid does not cover the image")
    if feats.dim() != 2 or feats.shape[1] >= 1 << 31:
        raise ValueError(f"features: need ({FEATURE_DIM}, K < 2^31), got "
                         f"{tuple(feats.shape)}")
    _build.check_tensor(feats, "features", torch.float32,
                        (FEATURE_DIM, feats.shape[1]), dev)
    for name, t in (("tile_start", bins.tile_start),
                    ("tile_end", bins.tile_end)):
        _build.check_tensor(t, name, torch.int32, (nt,), dev)
    nchan = 4 if config.alpha_channel else 3
    out = torch.empty((h, w, nchan), dtype=torch.float32, device=dev)
    if nt == 0 or h == 0 or w == 0:
        return out
    bg = [float(c) for c in config.background]
    fn = _build.library().splat_rasterize
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(bins.tile_start.data_ptr(), bins.tile_end.data_ptr(),
                 feats.data_ptr(), feats.shape[1], out.data_ptr(), h, w, tw,
                 th, bins.tiles_x, nt, config.chunk, config.alpha_clamp,
                 config.alpha_min, bg[0], bg[1], bg[2], nchan,
                 int(math.isfinite(config.sigma_cutoff)), ppt, stream)
    _build.check(err, "rasterize_tiles")
    rasterize_tiles.launches += 1
    return out


rasterize_tiles.launches = 0

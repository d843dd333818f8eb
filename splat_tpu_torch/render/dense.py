"""Dense renderer: every gaussian evaluated against every pixel.

PyTorch port of ``splat_tpu.render.dense``.  O(N * H * W) work, exact
semantics with no binning and no saturation exit: the port's parity anchor
on the card and the ``auto`` route for small scenes.  Gaussians are taken
front to back in stable depth order (ties by index), ``chunk`` at a time;
inside a chunk the exclusive cumulative product of (1 - alpha) gives each
splat's transmittance.
"""

from __future__ import annotations

import torch

from splat_tpu_torch.config import RenderConfig
from splat_tpu_torch.ops.projection import project_gaussians
from splat_tpu_torch.utils.image import box_downsample


def _splat_alpha(proj, idx, px, py, config: RenderConfig):
    """Alpha of gaussians ``idx`` (K,) at pixel grids px/py (H, W)."""
    def col(t):
        return t[idx][:, None, None]

    cx, cy = col(proj.center_px[:, 0]), col(proj.center_px[:, 1])
    ca, cb, cc = (col(proj.conic[:, i]) for i in range(3))
    rx, ry = col(proj.radius_px[:, 0]), col(proj.radius_px[:, 1])
    op = col(proj.opacity)
    visible = col(proj.visible)

    dx = px[None] - cx
    dy = cy - py[None]  # local +y up (reference quad orientation)
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    alpha = torch.clamp(op * torch.exp(power), max=config.alpha_clamp)
    keep = ((power <= 0)
            & (alpha >= config.alpha_min)
            & (torch.abs(dx) <= rx) & (torch.abs(dy) <= ry)
            & visible)
    return torch.where(keep, alpha, torch.zeros_like(alpha))


def depth_order(proj) -> torch.Tensor:
    """Front to back, ties by index; invisible splats sort last (their
    alpha is 0 anyway)."""
    key = torch.where(proj.visible, proj.depth,
                      torch.full_like(proj.depth, float("inf")))
    return torch.argsort(key, stable=True)


def composite_rows(proj, order, row0: int, h: int, w: int,
                   config: RenderConfig, chunk: int):
    """Composite the gaussians ``order`` of ``proj`` front to back over the
    image rows [row0, row0 + h), ``chunk`` at a time.  Returns the colour
    before the background, (h, w, 3), and the transmittance, (h, w)."""
    dev = proj.depth.device
    py, px = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    py = py + float(row0)
    img = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
    transmit = torch.ones((h, w), dtype=torch.float32, device=dev)
    color_all = torch.clamp(proj.color, 0.0, 1.0)
    for start in range(0, order.shape[0], chunk):
        idx = order[start:start + chunk]
        alpha = _splat_alpha(proj, idx, px, py, config)       # (K, H, W)
        t_within = torch.cumprod(1.0 - alpha, dim=0)
        t_before = torch.cat([torch.ones_like(t_within[:1]),
                              t_within[:-1]], dim=0)
        contrib = torch.einsum("khw,kc->hwc", alpha * t_before,
                               color_all[idx])
        img = img + transmit[..., None] * contrib
        transmit = transmit * t_within[-1]
    return img, transmit


def render_dense(scene, camera, config: RenderConfig | None = None,
                 *, chunk: int = 16) -> torch.Tensor:
    """Render to float32 (H, W, 3) in [0, 1] — (H, W, 4) RGBA with
    config.alpha_channel (fourth channel = accumulated 1 - T)."""
    config = config or RenderConfig()
    ss = config.supersample
    if ss > 1:
        camera = camera.scaled(ss)
    h, w = camera.h, camera.w
    dev = scene.device
    camera = camera.to(dev)
    bg = torch.tensor(config.background, dtype=torch.float32, device=dev)
    if scene.num_gaussians == 0:
        bgc = (torch.cat([bg, torch.zeros(1, device=dev)])
               if config.alpha_channel else bg)
        return bgc.expand(h // ss, w // ss, bgc.shape[0]).clone()
    proj = project_gaussians(scene, camera, config)

    img, transmit = composite_rows(proj, depth_order(proj), 0, h, w, config,
                                   chunk)
    img = img + transmit[..., None] * bg
    if config.alpha_channel:
        img = torch.cat([img, 1.0 - transmit[..., None]], dim=-1)
    img = torch.clamp(img, 0.0, 1.0)
    return box_downsample(img, ss)

"""Geometric debug overlay: conic outlines and bounding boxes in screen
space (port of ``splat_tpu.utils.overlay``, the notebook's
``plot_conics_and_bbs``), to check projection, conics and boxes apart from
blending.  A NumPy raster, no plotting library."""

from __future__ import annotations

import numpy as np
import torch

_COLORS = np.array([
    [1.0, 0.2, 0.2], [0.2, 1.0, 0.2], [0.3, 0.5, 1.0],
    [1.0, 1.0, 0.2], [1.0, 0.3, 1.0], [0.2, 1.0, 1.0],
], np.float32)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def draw_conics_and_bbs(proj, h: int, w: int, *, sigma: float = 1.0,
                        bbox: bool = True, max_gaussians: int = 64,
                        image=None) -> np.ndarray:
    """Draw the conic outline at ``sigma`` deviations and the box of each
    of the first ``max_gaussians`` visible splats of ``proj`` (a
    ProjectedGaussians), over ``image`` ((H, W, 3) float) or black.
    Returns (H, W, 3) float32."""
    img = (np.zeros((h, w, 3), np.float32) if image is None
           else np.array(_np(image), np.float32, copy=True))
    center = _np(proj.center_px)
    conic = _np(proj.conic)
    radius = _np(proj.radius_px)
    visible = _np(proj.visible)

    ys, xs = np.mgrid[0:h, 0:w]
    count = 0
    for i in range(center.shape[0]):
        if not visible[i]:
            continue
        if count >= max_gaussians:
            break
        color = _COLORS[count % len(_COLORS)]
        cx, cy = center[i]
        a, b, c = conic[i]
        rx, ry = radius[i]
        x1, x2 = int(max(cx - rx - 2, 0)), int(min(cx + rx + 3, w))
        y1, y2 = int(max(cy - ry - 2, 0)), int(min(cy + ry + 3, h))
        if x1 >= x2 or y1 >= y2:
            continue
        dx = xs[y1:y2, x1:x2] - cx
        dy = cy - ys[y1:y2, x1:x2]
        # Q = sigma^2 on the outline: draw where |Q - sigma^2| is within
        # ~1 px of it, relative to the local gradient
        q = a * dx * dx + 2.0 * b * dx * dy + c * dy * dy
        grad = 2.0 * np.sqrt(np.maximum(
            (a * dx + b * dy) ** 2 + (b * dx + c * dy) ** 2, 1e-12))
        band = np.abs(q - sigma * sigma) <= grad * 0.75
        img[y1:y2, x1:x2][band] = color
        if bbox:
            bx1, bx2 = int(round(cx - rx)), int(round(cx + rx))
            by1, by2 = int(round(cy - ry)), int(round(cy + ry))
            for xx in (bx1, bx2):
                if 0 <= xx < w:
                    img[max(by1, 0):min(by2 + 1, h), xx] = color * 0.6
            for yy in (by1, by2):
                if 0 <= yy < h:
                    img[yy, max(bx1, 0):min(bx2 + 1, w)] = color * 0.6
        count += 1
    return np.clip(img, 0.0, 1.0)

"""EWA 3D->2D projection and per-gaussian screen-space quantities.

PyTorch port of ``splat_tpu.ops.projection.project_gaussians``: every flag
and convention is kept (the reference's EWA J-truncation, ``lowpass``,
``tight_radius``, ``sigma_cutoff=inf``, ``cov3d_transpose``,
``sh_stale_eye``, depth mode).  Plain elementwise tensor code, as the JAX
version is plain XLA.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from splat_tpu_torch.config import RenderConfig
from splat_tpu_torch.ops.sh import eval_sh_cols
from splat_tpu_torch.ops.transforms import compute_cov6_cols, pack_cov3d
from splat_tpu_torch.scene import DeviceScene


@dataclasses.dataclass(frozen=True)
class ProjectedGaussians:
    """Per-gaussian screen-space quantities (all (N, ...) float32).

    depth: (N,) view depth (-z_cam, positive in front).
    center_px: (N, 2) splat center in pixels (x, y).
    conic: (N, 3) upper triangle (a, b, c) of the inverse 2D covariance.
    radius_px: (N, 2) bbox half-extents in pixels.
    color: (N, 3) SH-evaluated RGB (+0.5, unclamped).
    opacity: (N,) activated opacities.
    visible: (N,) bool.
    """

    depth: torch.Tensor
    center_px: torch.Tensor
    conic: torch.Tensor
    radius_px: torch.Tensor
    color: torch.Tensor
    opacity: torch.Tensor
    visible: torch.Tensor


def ewa_project(means, cov3d, view, htanx, htany, focal,
                lowpass: float) -> torch.Tensor:
    """(N, 3, 3) world covariances -> (N, 2, 2) pixel-space covariances
    (reference src/gaussians.rs:114-161).  ``htanx`` / ``htany`` are
    accepted as ``splat_tpu`` accepts them and have no effect: the
    reference's tan(fov) clamp touches only terms its truncation drops."""
    del htanx, htany
    a, b, c = ewa_project_packed(means, pack_cov3d(cov3d), view, focal,
                                 lowpass)
    return torch.stack([torch.stack([a, b], dim=-1),
                        torch.stack([b, c], dim=-1)], dim=-2)


def ewa_project_packed(means, cov6, view, focal, lowpass: float):
    """(N, 3) means and (N, 6) packed covariances -> the (a, b, c) terms,
    each (N,), of the 2D pixel-space covariance: (f / tz)^2 times u^T S u,
    u^T S v, v^T S v with u, v the first two rows of the view rotation,
    plus ``lowpass`` on the diagonal (the reference's truncated EWA)."""
    xx, xy, xz, yy, yz, zz = (cov6[:, i] for i in range(6))
    u, v = view[0, :3], view[1, :3]

    def quad(p, q):  # p^T Sigma q, elementwise over N
        return (xx * (p[0] * q[0]) + yy * (p[1] * q[1]) + zz * (p[2] * q[2])
                + xy * (p[0] * q[1] + p[1] * q[0])
                + xz * (p[0] * q[2] + p[2] * q[0])
                + yz * (p[1] * q[2] + p[2] * q[1]))

    tz = (view[2, 0] * means[:, 0] + view[2, 1] * means[:, 1]
          + view[2, 2] * means[:, 2] + view[2, 3])
    s2 = (focal / tz) ** 2
    return (s2 * quad(u, u) + lowpass, s2 * quad(u, v),
            s2 * quad(v, v) + lowpass)


def encode_depth_color(depth, visible, config: RenderConfig):
    """Normalized view depth in [0, 1] for ``render_mode="depth"``:
    ``config.depth_range`` or this frame's visible min/max."""
    if config.depth_range is not None:
        lo, hi = (torch.full((), v, dtype=torch.float32, device=depth.device)
                  for v in config.depth_range)
    else:
        lo = torch.min(torch.where(visible, depth, math.inf))
        hi = torch.max(torch.where(visible, depth, -math.inf))
        # empty frame / single depth plane: keep the division finite
        ok = torch.isfinite(lo) & (hi > lo)
        lo = torch.where(ok, lo, torch.zeros_like(lo))
        hi = torch.where(ok, hi, lo + 1.0)
    return torch.clamp((depth - lo) / (hi - lo), 0.0, 1.0)


def _scene_cols(scene):
    """The (N,) component columns of a scene of either layout: means
    (3), quaternion (4), scales (3), opacities, and the 48 SH columns
    (``shs[3 * k + c]``).  A DeviceScene's fields pass through, each a
    dense row; a GaussianScene's are strided column views of its
    (N, 3)/(N, 4)/(N, 16, 3) tensors, the same values read with a stride
    (``pack_device()`` once for a frame loop)."""
    if isinstance(scene, DeviceScene):
        return ((scene.mx, scene.my, scene.mz),
                (scene.qw, scene.qx, scene.qy, scene.qz),
                (scene.sx, scene.sy, scene.sz), scene.opacities,
                tuple(scene.sh))
    m, q, s, sh = scene.means, scene.quats, scene.scales, scene.sh
    return ((m[:, 0], m[:, 1], m[:, 2]),
            (q[:, 0], q[:, 1], q[:, 2], q[:, 3]),
            (s[:, 0], s[:, 1], s[:, 2]), scene.opacities,
            tuple(sh[:, k, c] for k in range(16) for c in range(3)))


def project_gaussians(scene, camera, config: RenderConfig) -> ProjectedGaussians:
    """All per-gaussian screen-space quantities for one frame, from a
    ``GaussianScene`` or a ``DeviceScene`` (the same values either way)."""
    view = camera.view_matrix()
    fx, fy, cx0, cy0 = camera.intrinsics_px()
    (mx, my, mz), q4, s3, opacity, shs = _scene_cols(scene)

    if config.cov3d_transpose:
        # R(q*) = R(q)^T: the notebook's R^T diag(s^2) R ordering
        qw, qx, qy, qz = q4
        q4 = (qw, -qx, -qy, -qz)
    xx, xy_, xz, yy, yz, zz = compute_cov6_cols(q4, s3)

    px = view[0, 0] * mx + view[0, 1] * my + view[0, 2] * mz + view[0, 3]
    py = view[1, 0] * mx + view[1, 1] * my + view[1, 2] * mz + view[1, 3]
    pz = view[2, 0] * mx + view[2, 1] * my + view[2, 2] * mz + view[2, 3]

    # EWA 2D covariance: the reference's truncation keeps only the first
    # two view-rotation rows u, v (see splat_tpu/ops/projection.py).
    u = (view[0, 0], view[0, 1], view[0, 2])
    v = (view[1, 0], view[1, 1], view[1, 2])

    def quad(p, r):  # p^T Sigma r, elementwise over N
        return (xx * (p[0] * r[0]) + yy * (p[1] * r[1]) + zz * (p[2] * r[2])
                + xy_ * (p[0] * r[1] + p[1] * r[0])
                + xz * (p[0] * r[2] + p[2] * r[0])
                + yz * (p[1] * r[2] + p[2] * r[1]))

    sx = fx / pz
    sy = fy / pz
    a = (sx * sx) * quad(u, u) + config.lowpass
    b = (sx * sy) * quad(u, v)
    c = (sy * sy) * quad(v, v) + config.lowpass

    det = a * c - b * b
    det_safe = torch.where(det > 0, det, torch.ones_like(det))
    inv_det = 1.0 / det_safe
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

    # bbox half-extents: sigma_cutoff, shrunk to the opacity-aware kill
    # radius when tight_radius (lossless, marginal bound)
    cut2 = torch.full_like(opacity, config.sigma_cutoff) ** 2
    if config.tight_radius:
        qmax = 2.0 * torch.log(torch.clamp(opacity / config.alpha_min,
                                           min=1e-12))
        cut2 = torch.minimum(cut2, torch.clamp(qmax, min=0.0))
    rx = torch.sqrt(cut2 * torch.clamp(a, min=0.0))
    ry = torch.sqrt(cut2 * torch.clamp(c, min=0.0))

    clip_w = -pz
    cx = cx0 + fx * (px / clip_w)
    cy = cy0 - fy * (py / clip_w)
    depth = -pz

    eye = camera.sh_eye(config.sh_stale_eye)
    rdx = mx - eye[0]
    rdy = my - eye[1]
    rdz = mz - eye[2]
    rinv = 1.0 / torch.clamp(
        torch.sqrt(rdx * rdx + rdy * rdy + rdz * rdz), min=1e-12)
    col_r, col_g, col_b = eval_sh_cols(shs, rdx * rinv, rdy * rinv,
                                       rdz * rinv, config.sh_degree)

    visible = ((depth > camera.znear)
               & (det > 0)
               & (cx + rx > 0) & (cx - rx < camera.w)
               & (cy + ry > 0) & (cy - ry < camera.h)
               & torch.isfinite(cx) & torch.isfinite(cy)
               & (opacity >= config.alpha_min))

    if config.render_mode == "depth":
        dn = encode_depth_color(depth, visible, config)
        col_r = col_g = col_b = dn

    return ProjectedGaussians(depth=depth,
                              center_px=torch.stack([cx, cy], dim=-1),
                              conic=conic,
                              radius_px=torch.stack([rx, ry], dim=-1),
                              color=torch.stack([col_r, col_g, col_b],
                                                dim=-1),
                              opacity=opacity,
                              visible=visible)

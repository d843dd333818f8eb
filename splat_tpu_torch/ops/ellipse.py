"""Ellipse view of projected gaussians (port of ``splat_tpu.ops.ellipse``).

The reference carries an alternative formulation from the 'splatter'
project (reference src/gaussians.rs:172-243): a projected 2D gaussian as
explicit ellipse parameters (semi-axes, rotation, centre).  Useful for
debug overlays, splat statistics and LOD heuristics.  Elementwise over N.
"""

from __future__ import annotations

import torch

from splat_tpu_torch.ops.transforms import quat_to_rotmat


def projected_covariance_of_ellipsoid(means, quats, scales, view,
                                      clamp: float = 1.0) -> torch.Tensor:
    """The (N, 3, 3) homogeneous conic T^T T with T = M^T R_c J: M =
    diag(s) R the gaussian's transform (the reference scales the rotation's
    ROWS), R_c the camera-to-world rotation, J the unit-focal perspective
    Jacobian with view-plane coordinates clamped to +-clamp."""
    m = quat_to_rotmat(quats) * scales[..., :, None]
    cam_rot = view[:3, :3].T
    pos_cam = means @ view[:3, :3].T + view[:3, 3]
    tz = pos_cam[:, 2]
    tx = torch.clamp(pos_cam[:, 0] / tz, -clamp, clamp) * tz
    ty = torch.clamp(pos_cam[:, 1] / tz, -clamp, clamp) * tz
    inv = 1.0 / tz
    zeros = torch.zeros_like(inv)
    j_mat = torch.stack([
        torch.stack([inv, zeros, -tx * inv * inv], -1),
        torch.stack([zeros, inv, -ty * inv * inv], -1),
        torch.stack([zeros, zeros, zeros], -1),
    ], -2)
    rcj = torch.einsum("ab,nbc->nac", cam_rot, j_mat)
    t = torch.einsum("nba,nbc->nac", m, rcj)
    return torch.einsum("nba,nbc->nac", t, t)


def extract_scale_of_covariance(cov2d_a, cov2d_b, cov2d_c):
    """Semi-major and semi-minor axes of the 2x2 covariance (a, b; b, c)."""
    root = torch.sqrt((cov2d_a - cov2d_c) ** 2 + 4.0 * cov2d_b * cov2d_b)
    major = torch.sqrt(torch.clamp((cov2d_a + cov2d_c + root) * 0.5, min=0.0))
    minor = torch.sqrt(torch.clamp((cov2d_a + cov2d_c - root) * 0.5, min=0.0))
    return major, minor


def extract_rotation_of_ellipse(cov2d_a, cov2d_b, cov2d_c):
    """(sin phi, cos phi) of the ellipse's orientation by the half-angle
    identities, with the reference's sign conventions."""
    diff = cov2d_a - cov2d_c
    aa = diff * diff
    bb = aa + 4.0 * cov2d_b * cov2d_b
    pos = bb > 0
    c = 0.5 * torch.sqrt(torch.where(
        pos, aa / torch.where(pos, bb, torch.ones_like(bb)),
        torch.zeros_like(bb)))
    j = torch.sqrt(torch.clamp(0.5 - c, min=0.0))
    k = (-torch.sqrt(torch.clamp(0.5 + c, min=0.0)) * torch.sign(cov2d_b)
         * torch.sign(diff))
    flip = (cov2d_b < 0) | (diff < 0)
    j2 = torch.where(flip, -j, j)
    k2 = torch.where(flip, -k, k)
    swap = diff < 0
    return torch.where(swap, -k2, j2), torch.where(swap, j2, k2)


def extract_translation_of_ellipse(conic3):
    """Ellipse centre from an (N, 3, 3) homogeneous conic: where both
    partial derivatives of the implicit curve vanish."""
    a, b, c = conic3[:, 0, 0], conic3[:, 0, 1], conic3[:, 1, 1]
    d, e = conic3[:, 0, 2], conic3[:, 1, 2]
    disc = a * c - b * b
    inv = 1.0 / torch.where(disc != 0, disc, torch.ones_like(disc))
    return torch.stack([(b * e - c * d) * inv, (b * d - a * e) * inv], -1)

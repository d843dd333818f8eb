"""Quaternion / covariance transforms, elementwise over the gaussian axis.

PyTorch port of ``splat_tpu.ops.transforms.compute_cov6_cols``: the world
covariance R diag(s^2) R^T of the active Rust renderer (reference
src/gaussians.rs:101-113), as six (N,) columns.
"""

from __future__ import annotations

import torch


def compute_cov6_cols(q, s):
    """q = (qw, qx, qy, qz), s = (sx, sy, sz), each (N,); returns the
    (xx, xy, xz, yy, yz, zz) columns of R diag(s^2) R^T."""
    qw, qx, qy, qz = q
    sx, sy, sz = s
    inv = 1.0 / torch.clamp(
        torch.sqrt(qw * qw + qx * qx + qy * qy + qz * qz), min=1e-12)
    w, x, y, z = qw * inv, qx * inv, qy * inv, qz * inv
    # rotation entries, columns scaled by the per-axis scale
    m00 = (1 - 2 * (y * y + z * z)) * sx
    m01 = (2 * (x * y - w * z)) * sy
    m02 = (2 * (x * z + w * y)) * sz
    m10 = (2 * (x * y + w * z)) * sx
    m11 = (1 - 2 * (x * x + z * z)) * sy
    m12 = (2 * (y * z - w * x)) * sz
    m20 = (2 * (x * z - w * y)) * sx
    m21 = (2 * (y * z + w * x)) * sy
    m22 = (1 - 2 * (x * x + y * y)) * sz
    xx = m00 * m00 + m01 * m01 + m02 * m02
    xy = m00 * m10 + m01 * m11 + m02 * m12
    xz = m00 * m20 + m01 * m21 + m02 * m22
    yy = m10 * m10 + m11 * m11 + m12 * m12
    yz = m10 * m20 + m11 * m21 + m12 * m22
    zz = m20 * m20 + m21 * m21 + m22 * m22
    return xx, xy, xz, yy, yz, zz


def quat_to_rotmat(quats: torch.Tensor) -> torch.Tensor:
    """(N, 4) scalar-first quaternions -> (N, 3, 3) rotation matrices,
    normalising first."""
    q = quats / torch.clamp(torch.linalg.vector_norm(quats, dim=-1,
                                                     keepdim=True), min=1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], dim=-1),
    ]
    return torch.stack(rows, dim=-2)

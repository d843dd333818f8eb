"""Real spherical-harmonics color evaluation, degrees 0-3.

PyTorch port of ``splat_tpu.ops.sh``: ``eval_sh`` on (..., 16, 3)
coefficients, its column form ``eval_sh_cols`` and ``rgb_to_dc``, with the
same constants, band polynomials, degree-1 sign pattern and final +0.5
shift (reference src/gaussians.rs:11-99).
"""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def eval_sh(sh: torch.Tensor, dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """View-dependent color: sh (..., 16, 3) coefficients (DC first,
    interleaved RGB) and dirs (..., 3) unit view directions give (..., 3)
    colors with the +0.5 shift, unclamped."""
    shs = [sh[..., k, c] for k in range(16) for c in range(3)]
    cols = eval_sh_cols(shs, dirs[..., 0], dirs[..., 1], dirs[..., 2],
                        degree)
    return torch.stack(cols, dim=-1)


def rgb_to_dc(rgb) -> torch.Tensor:
    """Inverse of the DC band: the sh[..., 0, :] that gives color ``rgb``
    (the full-precision SH_C0; the reference's fixture truncates it)."""
    return (torch.as_tensor(rgb, dtype=torch.float32) - 0.5) / SH_C0


def eval_sh_cols(shs, x, y, z, degree: int):
    """48 (N,) coefficient columns in, (r, g, b) columns out.

    shs[k * 3 + c] is coefficient k of channel c; x/y/z are the unit
    view-direction components.  Colors carry the +0.5 shift, unclamped.
    """
    if not 0 <= degree <= 3:
        raise ValueError(f"degree must be in [0,3], got {degree}")

    def band(k):
        return shs[3 * k], shs[3 * k + 1], shs[3 * k + 2]

    out = [SH_C0 * c for c in band(0)]
    if degree >= 1:
        for i, c in enumerate(band(1)):
            out[i] = out[i] - SH_C1 * y * c
        for i, c in enumerate(band(2)):
            out[i] = out[i] + SH_C1 * z * c
        for i, c in enumerate(band(3)):
            out[i] = out[i] - SH_C1 * x * c
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        basis2 = (SH_C2[0] * xy, SH_C2[1] * yz,
                  SH_C2[2] * (2.0 * zz - xx - yy),
                  SH_C2[3] * xz, SH_C2[4] * (xx - yy))
        for k, bk in enumerate(basis2):
            for i, c in enumerate(band(4 + k)):
                out[i] = out[i] + bk * c
    if degree >= 3:
        basis3 = (SH_C3[0] * y * (3.0 * xx - yy),
                  SH_C3[1] * xy * z,
                  SH_C3[2] * y * (4.0 * zz - xx - yy),
                  SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                  SH_C3[4] * x * (4.0 * zz - xx - yy),
                  SH_C3[5] * z * (xx - yy),
                  SH_C3[6] * x * (xx - 3.0 * yy))
        for k, bk in enumerate(basis3):
            for i, c in enumerate(band(9 + k)):
                out[i] = out[i] + bk * c
    return out[0] + 0.5, out[1] + 0.5, out[2] + 0.5

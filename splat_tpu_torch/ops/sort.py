"""Depth ordering (port of ``splat_tpu.ops.sort``): camera-space z of the
centres, argsorted.  Visible points have negative z in the right-handed
``look_at`` frame, so ascending order is farthest first, the painter's
order."""

from __future__ import annotations

import torch


def camera_space_z(means, view: torch.Tensor) -> torch.Tensor:
    """(N,) camera-space z of world-space points (negative in front)."""
    means = torch.as_tensor(means, dtype=torch.float32, device=view.device)
    return (view[2, 0] * means[:, 0] + view[2, 1] * means[:, 1]
            + view[2, 2] * means[:, 2] + view[2, 3])


def sort_gaussians(scene, camera) -> torch.Tensor:
    """Back-to-front (painter's) order, the reference's sort."""
    return torch.argsort(camera_space_z(scene.means, camera.view_matrix()),
                         stable=True)


def sort_gaussians_front_to_back(scene, camera) -> torch.Tensor:
    """Front-to-back order, what the compositing renderers take."""
    return torch.argsort(-camera_space_z(scene.means, camera.view_matrix()),
                         stable=True)

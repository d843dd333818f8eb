"""Where the port's constructors put their tensors.

Every constructor and loader (``GaussianScene.create``, ``Camera.create``,
the fixtures, ``load_ply``) takes ``device=None`` to mean the first CUDA
card.  Without one it raises: a scene built without a device never lands
on the CPU by accident, where every kernel wrapper would quietly take its
plain PyTorch version.  ``device="cpu"`` asks for the CPU explicitly.

:func:`filled` builds a small constant on the device without a copy from
the host, which a frame being captured into a CUDA graph may not make.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means ``cuda:0``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "splat_tpu_torch puts tensors on cuda:0 by default and no CUDA "
            "device is available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", 0)


def filled(values, device) -> torch.Tensor:
    """A float32 vector of ``values``, one fill each on ``device``: the
    same numbers as ``torch.tensor(values)``, with no host copy."""
    out = torch.empty(len(values), dtype=torch.float32, device=device)
    for i, v in enumerate(values):
        out[i].fill_(float(v))        # out[i] = v would copy from the host
    return out

"""Gaussian scene data model (PyTorch port of ``splat_tpu.scene``).

One structure-of-arrays batch of N gaussians as float32 tensors on one
device.  All activations (exp scales, sigmoid opacity, normalized
quaternions) are applied at load time, exactly as in ``splat_tpu``.  The
TPU package's feature-major ``DeviceScene`` exists only for the TPU's
memory layout and has no counterpart here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from splat_tpu_torch.device import resolve_device

_FIELDS = ("means", "quats", "scales", "opacities", "sh")


@dataclasses.dataclass(frozen=True)
class GaussianScene:
    """SoA batch of N gaussians.

    Attributes:
      means: (N, 3) float32 world-space centers.
      quats: (N, 4) float32 unit quaternions, scalar-first (w, x, y, z).
      scales: (N, 3) float32, exp-activated.
      opacities: (N,) float32 in (0, 1), sigmoid-activated.
      sh: (N, 16, 3) float32 SH coefficients, coefficient-major with
        interleaved RGB (sh[:, 0] is the DC term).
    """

    means: torch.Tensor
    quats: torch.Tensor
    scales: torch.Tensor
    opacities: torch.Tensor
    sh: torch.Tensor

    @property
    def num_gaussians(self) -> int:
        return self.means.shape[0]

    def __len__(self) -> int:
        return self.num_gaussians

    @property
    def device(self) -> torch.device:
        return self.means.device

    @classmethod
    def create(cls, means, quats, scales, opacities, sh,
               device=None) -> "GaussianScene":
        """Build a scene from array-likes, validating shapes.

        device: where the tensors live (None = cuda:0, raising without a
        CUDA device; see :mod:`splat_tpu_torch.device`).  Array inputs are
        copied.
        """
        device = resolve_device(device)

        def t(a):
            if isinstance(a, torch.Tensor):
                return a.to(device=device, dtype=torch.float32)
            return torch.tensor(np.asarray(a, np.float32), device=device)

        means, quats, scales, sh = t(means), t(quats), t(scales), t(sh)
        opacities = t(opacities).reshape(-1)
        n = means.shape[0]
        if sh.ndim == 2:  # (N, 48) flat layout -> (N, 16, 3)
            sh = sh.reshape(n, -1, 3)
        if sh.shape[1] < 16:  # pad missing high-order coefficients with zeros
            sh = torch.nn.functional.pad(sh, (0, 0, 0, 16 - sh.shape[1]))
        want = {"means": (n, 3), "quats": (n, 4), "scales": (n, 3),
                "opacities": (n,), "sh": (n, 16, 3)}
        got = {"means": means, "quats": quats, "scales": scales,
               "opacities": opacities, "sh": sh}
        for name, shape in want.items():
            if tuple(got[name].shape) != shape:
                raise ValueError(f"{name}: expected shape {shape}, "
                                 f"got {tuple(got[name].shape)}")
        return cls(means=means.contiguous(), quats=quats.contiguous(),
                   scales=scales.contiguous(),
                   opacities=opacities.contiguous(), sh=sh.contiguous())

    @classmethod
    def from_numpy(cls, d: dict, device=None) -> "GaussianScene":
        """From the dict ``splat_tpu.GaussianScene.to_numpy()`` returns."""
        return cls.create(*(d[k] for k in _FIELDS), device=device)

    def to_numpy(self) -> dict[str, np.ndarray]:
        """Inverse of :meth:`from_numpy`: field name -> float32 array."""
        return {k: getattr(self, k).detach().cpu().numpy() for k in _FIELDS}

    def to(self, device) -> "GaussianScene":
        """The same scene with every tensor on ``device``."""
        return GaussianScene(**{k: getattr(self, k).to(device)
                                for k in _FIELDS})

    def pad_to(self, n: int) -> "GaussianScene":
        """Pad with fully transparent degenerate gaussians up to ``n``
        rows, as ``splat_tpu``'s ``pad_to``: means 1e8 (far behind any
        plausible camera), identity quaternions, scales 1e-8, opacity 0,
        SH 0.  Sharding over ``g`` ranks needs N divisible by g."""
        cur = self.num_gaussians
        if n < cur:
            raise ValueError(f"pad_to({n}) smaller than current N={cur}")
        if n == cur:
            return self
        pad = n - cur
        kw = dict(dtype=torch.float32, device=self.device)
        quat = torch.tensor([[1.0, 0.0, 0.0, 0.0]], **kw).expand(pad, 4)
        return GaussianScene(
            means=torch.cat([self.means, torch.full((pad, 3), 1e8, **kw)]),
            quats=torch.cat([self.quats, quat]),
            scales=torch.cat([self.scales, torch.full((pad, 3), 1e-8, **kw)]),
            opacities=torch.cat([self.opacities, torch.zeros(pad, **kw)]),
            sh=torch.cat([self.sh, torch.zeros((pad, 16, 3), **kw)]))

    def slice(self, start: int, stop: int) -> "GaussianScene":
        """Rows [start, stop) of every field (views, not copies)."""
        return GaussianScene(**{k: getattr(self, k)[start:stop]
                                for k in _FIELDS})

    def permuted(self, seed: int = 0) -> "GaussianScene":
        """The gaussians in a random order: the permutation of
        ``np.random.default_rng(seed)``, so ``splat_tpu``'s ``permuted``
        gives the same order.  Rendering does not depend on the order, but
        the a2a slab routing's per-(source, destination) capacity assumes
        contiguous shards that are spatially uncorrelated, which a scene
        stored in spatial order breaks."""
        perm = torch.from_numpy(np.random.default_rng(seed).permutation(
            self.num_gaussians)).to(self.device)
        return GaussianScene(**{k: getattr(self, k)[perm] for k in _FIELDS})

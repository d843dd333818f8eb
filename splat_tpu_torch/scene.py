"""Gaussian scene data model (PyTorch port of ``splat_tpu.scene``).

Two layouts of N gaussians as float32 tensors on one device, as in
``splat_tpu``:

* :class:`GaussianScene`, structure of arrays: (N, 3) means, (N, 4)
  quaternions, (N, 3) scales, (N,) opacities, (N, 16, 3) SH.  Loaders,
  training and the scene helpers work on it.
* :class:`DeviceScene`, feature major: one dense (N,) row per component,
  all rows views of one contiguous (59, N) buffer
  (:meth:`GaussianScene.pack_device`).  The inference frame reads it.  A
  column of an (N, 3)/(N, 4)/(N, 16, 3) tensor is a strided input, which
  sends PyTorch's elementwise kernels down their non-vectorized path and
  reads a 32-byte sector for each 4-byte value; a row of the buffer is
  one dense stream (PERF.md: the projection's device time halves).

All activations (exp scales, sigmoid opacity, normalized quaternions) are
applied at load time, exactly as in ``splat_tpu``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from splat_tpu_torch.device import resolve_device

_FIELDS = ("means", "quats", "scales", "opacities", "sh")
# rows of a DeviceScene's buffer: mx, my, mz, qw, qx, qy, qz, sx, sy, sz,
# opacities, then sh[3 * k + c] for coefficient k of channel c
PACKED_ROWS = 11 + 48


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

    def pack_device(self, device=None) -> "DeviceScene":
        """The feature-major :class:`DeviceScene` of this scene: one
        (59, N) buffer filled by five copies, its rows the fields.

        device: where the buffer lives (None: the scene's own device; the
        port moves no tensor implicitly).  Packs run under ``no_grad``
        and outside ``inference_mode``, so a pack made inside either is
        an ordinary tensor that any later code may use.

        The default-device pack is memoized on the scene, so the
        auto-packing ``render()`` packs once per scene and its capacity
        cache, keyed by the packed object, keeps hitting.  Tensors are
        mutable where ``splat_tpu``'s arrays are not: the memo is keyed
        on every leaf's storage address and version counter, so a leaf
        edited in place (``scene.means.add_(...)``, or through a view)
        gives a fresh pack.  Edits through ``.data``, which bypass the
        version counter, are not seen.  Scenes of inference tensors,
        which have no version counter, are packed afresh every call.
        """
        leaves = tuple(getattr(self, k) for k in _FIELDS)
        memo = device is None and not any(t.is_inference() for t in leaves)
        if memo:
            key = tuple((t.data_ptr(), t._version) for t in leaves)
            hit = self.__dict__.get("_packed_cache")
            if hit is not None and hit[0] == key:
                return hit[1]
        n = self.num_gaussians
        with torch.inference_mode(False), torch.no_grad():
            buf = torch.empty((PACKED_ROWS, n), dtype=torch.float32,
                              device=self.device if device is None
                              else torch.device(device))
            buf[0:3].copy_(self.means.T)
            buf[3:7].copy_(self.quats.T)
            buf[7:10].copy_(self.scales.T)
            buf[10].copy_(self.opacities)
            buf[11:].copy_(self.sh.reshape(n, 48).T)
        out = DeviceScene.from_buffer(buf)
        if memo:
            object.__setattr__(self, "_packed_cache", (key, out))
        return out


@dataclasses.dataclass(frozen=True)
class DeviceScene:
    """Feature-major scene: one dense (N,) float32 row per component.

    The fields are ``splat_tpu.DeviceScene``'s, in its order; ``sh`` is a
    48-tuple in which ``sh[3 * k + c]`` is coefficient k of channel c
    (the order of ``GaussianScene.sh``).  Made by
    :meth:`GaussianScene.pack_device` or :meth:`from_buffer`, every field
    is a row view of one (59, N) buffer (:attr:`buffer`).  Read by
    ``ops.projection._scene_cols``: the inference frame, ``render()``, the
    command line, the viewer and the sharded renders take it.  Training
    takes a ``GaussianScene``.
    """

    mx: torch.Tensor
    my: torch.Tensor
    mz: torch.Tensor
    qw: torch.Tensor
    qx: torch.Tensor
    qy: torch.Tensor
    qz: torch.Tensor
    sx: torch.Tensor
    sy: torch.Tensor
    sz: torch.Tensor
    opacities: torch.Tensor
    sh: tuple

    @property
    def num_gaussians(self) -> int:
        return self.mx.shape[0]

    def __len__(self) -> int:
        return self.num_gaussians

    @property
    def device(self) -> torch.device:
        return self.mx.device

    @classmethod
    def from_buffer(cls, buf: torch.Tensor) -> "DeviceScene":
        """The scene whose fields are the rows of ``buf``, a
        (PACKED_ROWS, N) tensor in the order of :data:`PACKED_ROWS`.  The
        fields are views, and stay dense rows for a column slice
        ``buf[:, a:b]`` too (a shard of the gaussians)."""
        if buf.ndim != 2 or buf.shape[0] != PACKED_ROWS:
            raise ValueError(f"a packed buffer is ({PACKED_ROWS}, N), got "
                             f"{tuple(buf.shape)}")
        rows = buf.unbind(0)
        out = cls(*rows[:11], sh=tuple(rows[11:]))
        object.__setattr__(out, "_buffer", buf)
        return out

    @property
    def buffer(self) -> torch.Tensor:
        """The (PACKED_ROWS, N) buffer the fields are rows of; for a scene
        built field by field, a fresh stack of them."""
        buf = self.__dict__.get("_buffer")
        if buf is None:
            buf = torch.stack((self.mx, self.my, self.mz, self.qw, self.qx,
                               self.qy, self.qz, self.sx, self.sy, self.sz,
                               self.opacities, *self.sh))
        return buf

    def permuted(self, seed: int = 0) -> "DeviceScene":
        """The gaussians in ``GaussianScene.permuted(seed)``'s order (the
        permutation of ``np.random.default_rng(seed)``), packed."""
        perm = torch.from_numpy(np.random.default_rng(seed).permutation(
            self.num_gaussians)).to(self.device)
        return DeviceScene.from_buffer(self.buffer[:, perm])

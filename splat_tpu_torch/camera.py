"""Orbit camera (PyTorch port of ``splat_tpu.camera.Camera``).

Conventions preserved exactly (see ``splat_tpu/camera.py``): right-handed
``look_at`` with COLMAP-style ``up = (0, -1, 0)``, GL perspective with NDC z
in [-1, 1], focal = h / (2 tan(fovy/2)), and the reference's orbit: yaw
about ``up``, then pitch about ``up x base position`` (the UNROTATED base
position, a reference quirk kept on purpose) with a pole guard.

Pose fields are float32 tensors on the camera's device; ``h``/``w`` are
ints.  Every matrix is built on that device.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from splat_tpu_torch.device import resolve_device


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Orbit camera.  ``h``/``w`` size the image; the rest is the pose."""

    position: torch.Tensor   # (3,) base position (pre-orbit), world space
    target: torch.Tensor     # (3,) orbit pivot
    up: torch.Tensor         # (3,)
    yaw: torch.Tensor        # () radians, rotation about `up`
    pitch: torch.Tensor      # () radians, rotation about `up x position`
    znear: torch.Tensor      # ()
    zfar: torch.Tensor       # ()
    fovy: torch.Tensor       # () radians
    h: int
    w: int

    @classmethod
    def create(cls, h: int, w: int, position=(0.0, 0.0, 3.0),
               target=(0.0, 0.0, 0.0), up=(0.0, -1.0, 0.0),
               yaw: float = 0.0, pitch: float = 0.0,
               znear: float = 0.01, zfar: float = 100.0,
               fovy: float = math.pi / 2, device=None) -> "Camera":
        """device: where the pose tensors live (None = cuda:0, raising
        without a CUDA device)."""
        device = resolve_device(device)

        def v3(v):
            return _f32(v, device).reshape(3)

        return cls(position=v3(position), target=v3(target), up=v3(up),
                   yaw=_f32(yaw, device), pitch=_f32(pitch, device),
                   znear=_f32(znear, device), zfar=_f32(zfar, device),
                   fovy=_f32(fovy, device), h=int(h), w=int(w))

    @property
    def device(self) -> torch.device:
        return self.position.device

    def to(self, device) -> "Camera":
        """The same camera with its pose tensors on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name not in ("h", "w")})

    # -- pose updates (return a new Camera) ---------------------------------

    def rotate(self, dyaw: float = 0.0, dpitch: float = 0.0) -> "Camera":
        return dataclasses.replace(self, yaw=self.yaw + dyaw,
                                   pitch=self.pitch + dpitch)

    # -- derived quantities ---------------------------------------------------

    @property
    def aspect(self) -> float:
        return self.w / self.h

    def eye(self) -> torch.Tensor:
        """World-space camera position after the yaw/pitch orbit."""
        viewdir = _normalize(self.position - self.target)
        cos_angle = torch.dot(viewdir, self.up)
        pitch = torch.where(cos_angle * torch.sign(self.pitch) > 0.99,
                            torch.zeros_like(self.pitch), self.pitch)
        p = self.position - self.target
        p = _axis_angle_rotate(p, self.up, self.yaw)
        right = torch.linalg.cross(self.up, self.position)  # sic: base position
        p = _axis_angle_rotate(p, right, pitch)
        return p + self.target

    def sh_eye(self, stale: bool = False) -> torch.Tensor:
        """Ray origin for SH color; ``stale=True`` reproduces the reference
        viewer's un-orbited SH eye (PARITY.md)."""
        return self.position if stale else self.eye()

    def view_matrix(self) -> torch.Tensor:
        return look_at(self.eye(), self.target, self.up)

    def projection_matrix(self) -> torch.Tensor:
        return perspective(self.fovy, self.aspect, self.znear, self.zfar)

    def htanfovxy_focal(self):
        """(tan(fovx/2), tan(fovy/2), focal px)."""
        htany = torch.tan(self.fovy / 2)
        htanx = htany / self.h * self.w
        focal = self.h / (2.0 * htany)
        return htanx, htany, focal

    def intrinsics_px(self):
        """Pinhole intrinsics (fx, fy, cx, cy) in pixels: square pixels,
        centered principal point."""
        _, _, focal = self.htanfovxy_focal()
        return (focal, focal, _f32(self.w / 2, self.device),
                _f32(self.h / 2, self.device))

    def scaled(self, ss: int) -> "Camera":
        """Resolution scaled by ``ss`` with the field of view unchanged."""
        return dataclasses.replace(self, h=self.h * ss, w=self.w * ss)


def orbit_trajectory(camera: Camera, num_frames: int,
                     yaw_sweep: float = 2 * math.pi,
                     pitch_sweep: float = 0.0) -> list[Camera]:
    """``num_frames`` cameras whose yaw and pitch step linearly from the
    camera's own by up to ``yaw_sweep`` / ``pitch_sweep`` (both ends
    included).  ``splat_tpu`` returns one camera with a leading frame axis;
    the port returns a list, which ``fit`` and the renderers loop over."""
    ts = torch.linspace(0.0, 1.0, num_frames, dtype=torch.float32,
                        device=camera.device)
    yaws = camera.yaw + ts * yaw_sweep
    pitches = camera.pitch + ts * pitch_sweep
    return [dataclasses.replace(camera, yaw=yaws[i], pitch=pitches[i])
            for i in range(num_frames)]


def _normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v), min=eps)


def _axis_angle_rotate(v, axis, angle):
    """Rodrigues rotation of v about (possibly unnormalized) axis."""
    k = _normalize(axis)
    c, s = torch.cos(angle), torch.sin(angle)
    return (v * c + torch.linalg.cross(k, v) * s
            + k * torch.dot(k, v) * (1.0 - c))


def look_at(eye, center, up) -> torch.Tensor:
    """Right-handed look-at, glm convention."""
    f = _normalize(center - eye)
    s = _normalize(torch.linalg.cross(f, up))
    u = torch.linalg.cross(s, f)
    last = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float32,
                        device=eye.device)
    return torch.stack([
        torch.cat([s, -torch.dot(s, eye)[None]]),
        torch.cat([u, -torch.dot(u, eye)[None]]),
        torch.cat([-f, torch.dot(f, eye)[None]]),
        last,
    ]).to(torch.float32)


def perspective(fovy, aspect, znear, zfar) -> torch.Tensor:
    """Right-handed GL perspective, NDC z in [-1, 1] (glm RH_NO)."""
    fovy = torch.as_tensor(fovy, dtype=torch.float32)
    t = torch.tan(fovy / 2)
    znear = torch.as_tensor(znear, dtype=torch.float32, device=t.device)
    zfar = torch.as_tensor(zfar, dtype=torch.float32, device=t.device)
    zero = torch.zeros_like(t)
    one = torch.ones_like(t)
    return torch.stack([
        torch.stack([1.0 / (aspect * t), zero, zero, zero]),
        torch.stack([zero, 1.0 / t, zero, zero]),
        torch.stack([zero, zero, -(zfar + znear) / (zfar - znear),
                     -(2.0 * zfar * znear) / (zfar - znear)]),
        torch.stack([zero, zero, -one, zero]),
    ]).to(torch.float32)

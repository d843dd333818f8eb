"""Cameras (PyTorch port of ``splat_tpu.camera``).

Conventions preserved exactly (see ``splat_tpu/camera.py``): right-handed
``look_at`` with COLMAP-style ``up = (0, -1, 0)``, GL perspective with NDC z
in [-1, 1], focal = h / (2 tan(fovy/2)), and the reference's orbit: yaw
about ``up``, then pitch about ``up x base position`` (the UNROTATED base
position, a reference quirk kept on purpose) with a pole guard.
:class:`SE3Camera` is an explicit world-to-camera matrix with PINHOLE
intrinsics (fx != fy, off-centre principal point).  Both answer the
protocol the projection reads: ``view_matrix()``, ``intrinsics_px()``,
``sh_eye()``, ``znear``, ``h``, ``w``.

Pose fields are float32 tensors on the camera's device; ``h``/``w`` are
ints.  Every matrix is built on that device, and what a frame reads
(``view_matrix``, ``intrinsics_px``, ``sh_eye``) copies nothing from the
host, so a frame can be captured into a CUDA graph (``render/graph.py``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from splat_tpu_torch.device import filled, resolve_device


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _to(cam, device):
    """``cam`` with every tensor field on ``device`` (h and w are ints)."""
    return dataclasses.replace(cam, **{
        f.name: getattr(cam, f.name).to(device)
        for f in dataclasses.fields(cam) if f.name not in ("h", "w")})


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
        return _to(self, device)

    # -- pose updates (return a new Camera) ---------------------------------

    def with_pose(self, **kw) -> "Camera":
        """The camera with the named pose fields replaced (float32, on the
        camera's device)."""
        return dataclasses.replace(self, **{
            k: _f32(v, self.device) for k, v in kw.items()})

    def rotate(self, dyaw: float = 0.0, dpitch: float = 0.0) -> "Camera":
        return dataclasses.replace(self, yaw=self.yaw + dyaw,
                                   pitch=self.pitch + dpitch)

    def reset(self) -> "Camera":
        """Zero the orbit angles (the reference viewer's 'R' key)."""
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        return dataclasses.replace(self, yaw=zero, pitch=zero)

    # -- derived quantities ---------------------------------------------------

    @property
    def aspect(self) -> float:
        return self.w / self.h

    def eye(self) -> torch.Tensor:
        """World-space camera position after the yaw/pitch orbit."""
        p = self.position - self.target
        cos_angle = torch.dot(_normalize(p), self.up)
        pitch = torch.where(cos_angle * torch.sign(self.pitch) > 0.99,
                            torch.zeros_like(self.pitch), self.pitch)
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

    def record(self, stale: bool = False) -> torch.Tensor:
        """(20,) float32 on the camera's device: view rows 0-2, fx, fy,
        cx, cy, the SH eye (``sh_eye(stale)``) and znear, each equal bit
        for bit to what ``view_matrix``, ``intrinsics_px`` and ``sh_eye``
        give.  Device ops only, the eye computed once: a captured frame
        reads the pose each replay copies in."""
        eye = self.eye()
        s, u, f = _look_at_rows(eye, self.target, self.up)
        focal = (self.h / (2.0 * torch.tan(self.fovy / 2))).reshape(1)
        cx, cy = (torch.full((1,), v, dtype=torch.float32, device=self.device)
                  for v in (self.w / 2, self.h / 2))
        return torch.cat([s, -torch.dot(s, eye)[None], u,
                          -torch.dot(u, eye)[None], -f,
                          torch.dot(f, eye)[None], focal, focal, cx, cy,
                          self.position if stale else eye,
                          self.znear.reshape(1)])

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
        cx, cy = (torch.full((), v, dtype=torch.float32, device=self.device)
                  for v in (self.w / 2, self.h / 2))
        return focal, focal, cx, cy

    def scaled(self, ss: int) -> "Camera":
        """Resolution scaled by ``ss`` with the field of view unchanged."""
        return dataclasses.replace(self, h=self.h * ss, w=self.w * ss)

    def to_se3(self) -> "SE3Camera":
        """The same pose and intrinsics as an explicit SE(3) camera."""
        fx, fy, cx, cy = self.intrinsics_px()
        return SE3Camera(view=self.view_matrix(), fx=fx, fy=fy, cx=cx, cy=cy,
                         znear=self.znear, zfar=self.zfar, h=self.h, w=self.w)


@dataclasses.dataclass(frozen=True)
class SE3Camera:
    """Arbitrary-pose pinhole camera: a world-to-camera matrix plus
    COLMAP-style intrinsics in pixels.

    ``view`` follows :func:`look_at`'s frame (rows right, up', -forward),
    so visible points have negative camera-space z, as with the orbit
    camera.  A COLMAP world-to-camera (y down, z forward) converts through
    :meth:`from_colmap`.
    """

    view: torch.Tensor    # (4, 4) world-to-camera
    fx: torch.Tensor      # () focal in pixels, x
    fy: torch.Tensor      # () focal in pixels, y
    cx: torch.Tensor      # () principal point x, pixels
    cy: torch.Tensor      # () principal point y, pixels
    znear: torch.Tensor   # ()
    zfar: torch.Tensor    # ()
    h: int
    w: int

    @classmethod
    def create(cls, h: int, w: int, view, fx, fy=None, cx=None, cy=None,
               znear: float = 0.01, zfar: float = 100.0,
               device=None) -> "SE3Camera":
        """fy defaults to fx and (cx, cy) to the image centre.  device:
        where the tensors live (None = cuda:0, raising without a CUDA
        device)."""
        device = resolve_device(device)
        return cls(view=_f32(view, device).reshape(4, 4),
                   fx=_f32(fx, device),
                   fy=_f32(fy if fy is not None else fx, device),
                   cx=_f32(cx if cx is not None else w / 2, device),
                   cy=_f32(cy if cy is not None else h / 2, device),
                   znear=_f32(znear, device), zfar=_f32(zfar, device),
                   h=int(h), w=int(w))

    @classmethod
    def from_colmap(cls, qvec, tvec, fx, fy, cx, cy, h: int, w: int,
                    znear: float = 0.01, zfar: float = 100.0,
                    device=None) -> "SE3Camera":
        """From a COLMAP image record: world-to-camera rotation as a
        scalar-first quaternion and translation, PINHOLE intrinsics.
        COLMAP's frame is y down, z forward; this engine's is y up', z
        backward, so rows 1 and 2 of [R|t] flip."""
        device = resolve_device(device)
        q = _f32(qvec, device)
        q = q / torch.clamp(torch.linalg.vector_norm(q), min=1e-12)
        qw, qx, qy, qz = q[0], q[1], q[2], q[3]
        r = torch.stack([
            torch.stack([1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
                         2 * (qx * qz + qw * qy)]),
            torch.stack([2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
                         2 * (qy * qz - qw * qx)]),
            torch.stack([2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
                         1 - 2 * (qx * qx + qy * qy)]),
        ])
        t = _f32(tvec, device).reshape(3)
        flip = torch.tensor([1.0, -1.0, -1.0], dtype=torch.float32,
                            device=device)[:, None]
        rt = torch.cat([r * flip, (t * flip[:, 0])[:, None]], dim=1)
        view = torch.cat([rt, torch.tensor([[0.0, 0.0, 0.0, 1.0]],
                                           dtype=torch.float32,
                                           device=device)], dim=0)
        return cls(view=view, fx=_f32(fx, device), fy=_f32(fy, device),
                   cx=_f32(cx, device), cy=_f32(cy, device),
                   znear=_f32(znear, device), zfar=_f32(zfar, device),
                   h=int(h), w=int(w))

    @property
    def device(self) -> torch.device:
        return self.view.device

    def to(self, device) -> "SE3Camera":
        """The same camera with its tensors on ``device``."""
        return _to(self, device)

    @property
    def aspect(self) -> float:
        return self.w / self.h

    def eye(self) -> torch.Tensor:
        """World-space camera centre: view = [R|t] => eye = -R^T t."""
        return -(self.view[:3, :3].T @ self.view[:3, 3])

    def sh_eye(self, stale: bool = False) -> torch.Tensor:
        """SH ray origin; an SE(3) camera has no orbit state to go stale,
        so the flag changes nothing."""
        return self.eye()

    def view_matrix(self) -> torch.Tensor:
        return self.view

    def record(self, stale: bool = False) -> torch.Tensor:
        """(20,) float32, as :meth:`Camera.record` (``stale`` changes
        nothing here)."""
        return torch.cat([self.view[:3].reshape(12), self.fx.reshape(1),
                          self.fy.reshape(1), self.cx.reshape(1),
                          self.cy.reshape(1), self.eye(),
                          self.znear.reshape(1)]).to(torch.float32)

    def intrinsics_px(self):
        return self.fx, self.fy, self.cx, self.cy

    def htanfovxy_focal(self):
        """Per-axis half-tangents and the y focal (the reference defines
        its focal from the vertical field of view)."""
        return (self.w / (2.0 * self.fx), self.h / (2.0 * self.fy),
                self.fy)

    def scaled(self, ss: int) -> "SE3Camera":
        """Resolution scaled by ``ss`` with the field of view unchanged:
        every pixel-unit intrinsic scales with h and w."""
        return dataclasses.replace(
            self, h=self.h * ss, w=self.w * ss, fx=self.fx * ss,
            fy=self.fy * ss, cx=self.cx * ss, cy=self.cy * ss)

    def projection_matrix(self) -> torch.Tensor:
        """GL-style projection from the intrinsics, with principal-point
        terms in column 2, as ``splat_tpu`` builds it.  With a centred
        principal point, clip = P @ p_cam lands on the pixels
        ``intrinsics_px`` gives under :func:`ndc_to_pixel`; an off-centre
        one lands mirrored about the image centre, at (w - cx, h - cy).
        The renderers read ``intrinsics_px``, not this matrix."""
        zn, zf = self.znear, self.zfar
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        return torch.stack([
            torch.stack([2.0 * self.fx / self.w, zero,
                         (2.0 * self.cx / self.w) - 1.0, zero]),
            torch.stack([zero, 2.0 * self.fy / self.h,
                         1.0 - (2.0 * self.cy / self.h), zero]),
            torch.stack([zero, zero, -(zf + zn) / (zf - zn),
                         -(2.0 * zf * zn) / (zf - zn)]),
            torch.stack([zero, zero, -torch.ones_like(zero), zero]),
        ]).to(torch.float32)


def stack_cameras(cams) -> list:
    """Check that the cameras share one resolution and return them as the
    list ``fit`` and the renderers loop over.  ``splat_tpu`` stacks them
    into one pytree with a leading view axis; the port keeps a list, as its
    ``orbit_trajectory`` does."""
    cams = list(cams)
    if not cams:
        raise ValueError("stack_cameras: empty list")
    c0 = cams[0]
    if any((c.h, c.w) != (c0.h, c0.w) for c in cams):
        raise ValueError("stack_cameras: all cameras must share h, w "
                         "(they shape the output image)")
    return cams


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


def _look_at_rows(eye, center, up):
    """The look-at frame's axes: side, up and forward."""
    f = _normalize(center - eye)
    s = _normalize(torch.linalg.cross(f, up))
    return s, torch.linalg.cross(s, f), f


def look_at(eye, center, up) -> torch.Tensor:
    """Right-handed look-at, glm convention."""
    s, u, f = _look_at_rows(eye, center, up)
    last = filled((0.0, 0.0, 0.0, 1.0), eye.device)
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


def world_to_cam(camera, points) -> torch.Tensor:
    """(N, 3) world -> camera space."""
    view = camera.view_matrix()
    points = torch.as_tensor(points, dtype=torch.float32, device=view.device)
    return points @ view[:3, :3].T + view[:3, 3]


def cam_to_ndc(camera, points_cam) -> torch.Tensor:
    """(N, 3) camera space -> (N, 3) NDC, with the perspective divide."""
    proj = camera.projection_matrix()
    p = torch.as_tensor(points_cam, dtype=torch.float32, device=proj.device)
    clip = p @ proj[:3, :3].T + proj[:3, 3]
    w_clip = p @ proj[3, :3] + proj[3, 3]
    return clip / w_clip[:, None]


def ndc_to_pixel(ndc_xy, w: int, h: int) -> torch.Tensor:
    """NDC [-1, 1]^2 -> pixels with the loaders' y-flip:
    x_px = (x + 1) w / 2,  y_px = (1 - y) h / 2."""
    x = (ndc_xy[..., 0] + 1.0) * (w / 2)
    y = (1.0 - ndc_xy[..., 1]) * (h / 2)
    return torch.stack([x, y], dim=-1)

"""Seeded scene generators, on the device, from a configuration's
``scene`` block.

PyTorch copies of the laws of ``splat_tpu_torch.utils.fixtures``'
``surface_scene`` and ``random_scene`` (drawn with NumPy on the host
there), drawn here with one ``torch.Generator`` on the scene's device in a
few large calls, so that one seed gives the same scene twice and no
scene passes through the host.  Every number of a law comes from the
``scene`` block; :func:`generate` refuses a block with a key its law does
not read, or without one it does.

A scene is a dict of float32 tensors: ``means`` (N, 3), ``quats`` (N, 4,
unit, scalar first), ``scales`` (N, 3, activated), ``opacities`` (N,) and
``sh`` (N, 16, 3), the leaves ``splat_tpu_torch.GaussianScene.create``
takes.  The benchmark hands the same tensors to the program and to the
reference.
"""

from __future__ import annotations

import math

import torch

SH_C0 = 0.28209479177387814

# the keys each law reads from the scene block
LAW_KEYS = {
    "surface": {"law", "n", "extent", "blobs", "bump", "ground_y",
                "tangent_scale", "tangent_log_sd", "normal_ratio",
                "opacity_beta", "color_jitter", "sh_degree", "sh_rest_sd"},
    "random": {"law", "n", "extent", "volume_low", "scale_range",
               "opacity_beta", "sh_degree", "sh_rest_sd"},
}


def _uniform(gen, shape, lo, hi, device):
    return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo


def _normal(gen, shape, device):
    return torch.randn(shape, generator=gen, device=device)


def _gamma(gen, shape: int, k: float, device) -> torch.Tensor:
    """Gamma(k, 1) samples for k >= 1 by Marsaglia and Tsang's method:
    rejection rounds on the still-missing samples, all from ``gen``."""
    if k < 1.0:
        raise ValueError(f"gamma shape {k} < 1")
    d = k - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.empty(shape, device=device)
    todo = torch.arange(shape, device=device)
    while todo.numel():
        m = todo.numel()
        x = _normal(gen, m, device)
        u = torch.rand(m, generator=gen, device=device)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(torch.clamp(v, min=1e-30)))
        out[todo[ok]] = (d * v)[ok]
        todo = todo[~ok]
    return out


def _beta(gen, n: int, a: float, b: float, device) -> torch.Tensor:
    x = _gamma(gen, n, a, device)
    y = _gamma(gen, n, b, device)
    return x / (x + y)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _sh(gen, n, base, degree, sd, device):
    sh = torch.zeros((n, 16, 3), device=device)
    sh[:, 0, :] = (base - 0.5) / SH_C0
    if degree > 0:
        k = (degree + 1) ** 2
        sh[:, 1:k, :] = _normal(gen, (n, k - 1, 3), device) * sd
    return sh


def _quat_from_z(normals: torch.Tensor) -> torch.Tensor:
    """Unit quaternions turning local +z onto each unit normal."""
    z = torch.zeros_like(normals)
    z[:, 2] = 1.0
    axis = torch.linalg.cross(z, normals)
    norm = torch.linalg.vector_norm(axis, dim=1, keepdim=True)
    x_axis = torch.zeros_like(normals)
    x_axis[:, 0] = 1.0
    axis = torch.where(norm > 1e-6, axis / torch.clamp(norm, min=1e-12),
                       x_axis)
    half = torch.arccos(torch.clamp(normals[:, 2:3], -1.0, 1.0)) / 2
    return torch.cat([torch.cos(half), axis * torch.sin(half)], 1)


def _surface(p: dict, gen, device) -> dict:
    """Splats on ``blobs`` (centre and radius in world units, a bumped
    sphere each) and a ground plane at ``ground_y * extent``, oriented
    along the surface normal, thin along it."""
    n, extent = int(p["n"]), float(p["extent"])
    blobs = p["blobs"]
    per = n // (len(blobs) + 1)
    amp, fx, fy = p["bump"]
    means, normals = [], []
    for blob in blobs:
        d = _unit(_normal(gen, (per, 3), device))
        bump = 1.0 + amp * torch.sin(fx * d[:, 0]) * torch.cos(fy * d[:, 1])
        center = torch.tensor(blob["center"], device=device)
        means.append(center + blob["radius"] * d * bump[:, None])
        normals.append(d)
    m = n - per * len(blobs)
    xz = _uniform(gen, (m, 2), -extent, extent, device)
    ground = torch.stack([xz[:, 0], torch.full((m,), p["ground_y"] * extent,
                                               device=device), xz[:, 1]], 1)
    means.append(ground)                # y-down world: +y is the floor
    down = torch.zeros((m, 3), device=device)
    down[:, 1] = -1.0
    normals.append(down)
    means = torch.cat(means)
    quats = _quat_from_z(torch.cat(normals))

    area = extent * math.sqrt(1.0 / max(n, 1))
    tangent = torch.exp(math.log(p["tangent_scale"] * area)
                        + p["tangent_log_sd"] * _normal(gen, (n, 2), device))
    lo, hi = p["normal_ratio"]
    normal_s = tangent.amin(1, keepdim=True) * _uniform(gen, (n, 1), lo, hi,
                                                         device)
    scales = torch.cat([tangent, normal_s], 1)
    opacities = _beta(gen, n, *p["opacity_beta"], device)
    jitter = p["color_jitter"]
    base = 0.25 + 0.5 * (means / (2 * extent) + 0.5)
    base = torch.clamp(base + _uniform(gen, (n, 3), -jitter, jitter, device),
                       0.0, 1.0)
    sh = _sh(gen, n, base, p["sh_degree"], p["sh_rest_sd"], device)
    return {"means": means, "quats": quats, "scales": scales,
            "opacities": opacities, "sh": sh}


def _random(p: dict, gen, device) -> dict:
    n, extent = int(p["n"]), float(p["extent"])
    r = extent * torch.pow(_uniform(gen, n, p["volume_low"], 1.0, device),
                           1.0 / 3.0)
    means = r[:, None] * _unit(_normal(gen, (n, 3), device))
    quats = _unit(_normal(gen, (n, 4), device))
    lo, hi = (math.log(s) for s in p["scale_range"])
    scales = torch.exp(_uniform(gen, (n, 3), lo, hi, device))
    opacities = _beta(gen, n, *p["opacity_beta"], device)
    base = _uniform(gen, (n, 3), 0.0, 1.0, device)
    sh = _sh(gen, n, base, p["sh_degree"], p["sh_rest_sd"], device)
    return {"means": means, "quats": quats, "scales": scales,
            "opacities": opacities, "sh": sh}


_LAWS = {"surface": _surface, "random": _random}


def generate(scene: dict, seed: int, device) -> dict:
    """The scene of a configuration's ``scene`` block at ``seed``, drawn
    on ``device``."""
    law = scene.get("law")
    if law not in _LAWS:
        raise ValueError(f"unknown scene law {law!r}")
    keys = set(scene)
    if keys != LAW_KEYS[law]:
        raise ValueError(f"scene law {law!r} reads {sorted(LAW_KEYS[law])}; "
                         f"the block has {sorted(keys)}")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    with torch.no_grad():
        out = _LAWS[law](scene, gen, torch.device(device))
    return {k: v.to(torch.float32).contiguous() for k, v in out.items()}

"""The traffic's generator: the camera poses of a mix, from its parameters
(``traffic/<name>.json``), the configuration's camera and the seed.

A pose is a dict of float32 tensors on the device (``position``,
``target``, ``up``, ``yaw``, ``pitch``, ``znear``, ``zfar``, ``fovy``)
and the image size (``h``, ``w``): the fields of the program's orbit
``Camera`` and what the reference reads.  The benchmark makes them, and
hands the same tensors to both.
"""

from __future__ import annotations

import math

import torch


def base_pose(camera: dict, device) -> dict:
    """The configuration's camera at yaw 0, pitch 0."""
    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    return {"position": f32(camera["position"]),
            "target": f32(camera["target"]), "up": f32(camera["up"]),
            "yaw": f32(0.0), "pitch": f32(0.0), "znear": f32(camera["znear"]),
            "zfar": f32(camera["zfar"]), "fovy": f32(camera["fovy"]),
            "h": int(camera["h"]), "w": int(camera["w"])}


def orbit_path(traffic: dict, seed: int, device):
    """One period of an orbit mix's path: (yaws, pitches), float32 (P,)
    on the device.  Frame i of the window takes entry i mod P.

    The yaw starts uniform in [0, 2 pi) from the seed and advances one
    ``frames_per_turn``-th of a turn a frame; the pitch is
    ``pitch_amp * sin(2 pi i / pitch_period + phi)``, phi uniform from the
    seed.  P is the least common multiple of the two periods, so every
    seed's path visits the same set of poses, from another start.
    """
    turn = int(traffic["frames_per_turn"])
    period = int(traffic["pitch_period"])
    gen = torch.Generator().manual_seed(int(seed) % (1 << 64))
    yaw0, phi = (2.0 * math.pi * torch.rand(2, generator=gen,
                                            dtype=torch.float64)).tolist()
    p = math.lcm(turn, period)
    i = torch.arange(p, dtype=torch.float64)
    yaws = yaw0 + 2.0 * math.pi * torch.remainder(i, turn) / turn
    pitches = traffic["pitch_amp"] * torch.sin(2.0 * math.pi * i / period
                                               + phi)
    return (yaws.to(torch.float32).to(device),
            pitches.to(torch.float32).to(device))


def fit_views(traffic: dict, base: dict) -> list:
    """The views of a fit mix: yaw ``v * view_yaw_step``, pitch 0."""
    dev = base["yaw"].device
    return [dict(base, yaw=torch.tensor(v * traffic["view_yaw_step"],
                                        dtype=torch.float32, device=dev),
                 pitch=torch.zeros((), dtype=torch.float32, device=dev))
            for v in range(int(traffic["views"]))]

"""The plain reference against the port's own path on the CPU (where
every kernel runs its plain PyTorch version), at 2k gaussians and 128^2
pixels: frames equal to float32 rounding, training steps alike."""

import json
import math

import pytest
import torch

import splat_tpu_torch as stt
from splatbench import poses, scenes
from splatbench.reference import render as reference

from helpers import BENCH

H = W = 128


def _scene(config: str, seed: int, n: int = 2000):
    cfg = json.loads((BENCH.dir / "configs" / f"{config}.json").read_text())
    return scenes.generate(dict(cfg["scene"], n=n), seed, "cpu"), cfg


def _pose(cfg, yaw, pitch):
    base = poses.base_pose(dict(cfg["camera"], h=H, w=W), "cpu")
    return dict(base, yaw=torch.tensor(yaw), pitch=torch.tensor(pitch))


@pytest.mark.parametrize("config", ["surface-3m", "random-1m"])
def test_frame_matches_port(config):
    leaves, cfg = _scene(config, 2**31 + 11)
    pose = _pose(cfg, 0.7, 0.1)
    scene = stt.GaussianScene.create(**leaves, device="cpu")
    img = stt.render_tiled(scene, stt.Camera(**pose))
    ref = reference.render(leaves, pose, 32)
    assert img.shape == ref.shape == (H, W, 3)
    assert float((img - ref).abs().max()) < 5e-6
    # the scene is not empty on screen
    assert float(ref.mean()) > 0.01


def test_training_steps_match_port():
    leaves, cfg = _scene("surface-3m", 2**31 + 12, n=1500)
    views = [_pose(cfg, 0.0, 0.0), _pose(cfg, 0.05, 0.0)]
    for v in views:
        v["h"], v["w"] = 48, 64
    targets = torch.stack([reference.render(leaves, v, 32) for v in views])
    start = dict(leaves, sh=leaves["sh"] * 0.8)
    scales = {"means": 0.05, "quats": 0.25, "log_scales": 1.0,
              "logit_opacities": 2.5, "sh": 1.0}
    res = stt.fit(stt.GaussianScene.create(**start, device="cpu"),
                  [stt.Camera(**v) for v in views], targets, steps=2,
                  lr=5e-3, lr_scales=scales, method="tiled", l1_weight=0.2,
                  dssim_weight=0.2)
    recipe = {"l1_weight": 0.2, "dssim_weight": 0.2}
    raw0 = reference.raw_from_scene(start)
    raw, adam, losses = raw0, reference.Adam(raw0, 5e-3, scales), []
    for _ in range(2):
        loss, grads, _ = reference.loss_and_grads(raw, views, targets,
                                                  recipe)
        losses.append(float(loss))
        raw = adam.step(raw, grads)
    for p, r in zip(res.losses.tolist(), losses):
        assert abs(p - r) / r < 1e-4
    for k in reference.RAW_LEAVES:
        dp = float(torch.linalg.vector_norm(getattr(res.raw, k) - raw0[k]))
        dr = float(torch.linalg.vector_norm(raw[k] - raw0[k]))
        assert dr > 0 and math.isclose(dp, dr, rel_tol=1e-4)

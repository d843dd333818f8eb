"""The yardstick's counts against a hand count: three large gaussians
stacked in depth over a 64 x 32 frame of two 32 x 32 tiles."""

import math

import pytest
import torch

from splatbench import roofline
from splatbench.reference import render as reference


def _frame(opacity: float):
    leaves = {
        "means": torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.0, 0.1],
                               [0.0, 0.0, 0.2]]),
        "quats": torch.tensor([[1.0, 0.0, 0.0, 0.0]] * 3),
        "scales": torch.full((3, 3), 100.0),
        "opacities": torch.full((3,), opacity),
        "sh": torch.zeros((3, 16, 3)),
    }
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    pose = {"position": f32([0.0, 0.0, 4.0]), "target": f32([0.0] * 3),
            "up": f32([0.0, -1.0, 0.0]), "yaw": f32(0.0), "pitch": f32(0.0),
            "znear": f32(0.01), "zfar": f32(100.0), "fovy": f32(math.pi / 2),
            "h": 32, "w": 64}
    return leaves, pose


def test_translucent_stack_needs_every_pair():
    # opacity 0.5: T stays above 1/255 after the three pairs, so each of
    # the 2048 pixels needs all three, and keeps them (alpha > 0.49
    # everywhere: sigma is 400 px on screen)
    leaves, pose = _frame(0.5)
    _, w = reference.render(leaves, pose, 32, count=True)
    assert w == {"n": 3, "visible": 3, "pairs": 6, "tile_pairs": 6,
                 "tiles": 2, "evals": 6144, "kept": 6144, "box": 6144}
    nbytes, ops, sfu = roofline.k2_work(w, 2048)
    assert nbytes == 6 * 4 + 3 * 44 + 2 * 8 + 2048 * 12
    assert ops == 6144 * 14 + 6144 * 9
    assert sfu == 6144


def test_opaque_stack_stops_at_each_pixel():
    # opacity 0.99: after two pairs T < 1/255 at every pixel, so a pixel
    # needs two of its tile's three pairs, though the tile walks all three
    # (its exit comes after the batch); training needs all three, T never
    # being exactly 0
    leaves, pose = _frame(0.99)
    _, w = reference.render(leaves, pose, 32, count=True)
    assert (w["evals"], w["kept"], w["tile_pairs"]) == (4096, 4096, 4)
    _, wt = reference.train_image(leaves, pose, count=True)
    # on the training walk's 8 x 8 tiles: 32 tiles of three pairs each
    assert (wt["evals"], wt["kept"], wt["tile_pairs"], wt["tiles"]) == (
        6144, 6144, 96, 32)
    nbytes, ops, sfu = roofline.k4_work(wt, 2048)
    assert nbytes == 96 * 4 + 3 * 44 + 32 * 8 + 2048 * 20 + 3 * 36
    assert (ops, sfu) == (6144 * (14 + 33), 6144 * (1 + 3))


def test_least_seconds_names_its_bound():
    t, which = roofline.least_seconds(3.35e12, 1.0, 1.0)
    assert which == "bytes" and t == pytest.approx(1.0)
    t, which = roofline.least_seconds(1.0, 134e12, 1.0)
    assert which == "fp32" and t == pytest.approx(2.0)
    t, which = roofline.least_seconds(1.0, 1.0, roofline.SFU_OPS_PER_S)
    assert which == "sfu" and t == pytest.approx(1.0)

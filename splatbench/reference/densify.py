"""Plain PyTorch reference of 3DGS adaptive density control (ADC) and the
training loop around it.

The recipe is Kerbl et al. 2023, section 5.2 (arXiv:2308.04079), with the
authors' defaults: every ``interval`` steps, a splat whose accumulated
positional gradient exceeds ``grad_threshold`` is cloned if its largest
scale is at most ``percent_dense`` (0.01) times the scene extent, and
split if it is larger: split into two children at 1 / ``split_factor``
(1.6) of its scale, each placed by a sample of its own Gaussian; splats
below ``min_opacity`` (0.005) are pruned.  Where the benchmark's recipe
departs from the paper (the configuration lists each under ``assumed``):

* the gradient statistic is the world-space norm of the means' gradient,
  averaged over every step since the last round (INRIA: the screen-space
  gradient averaged over the views that see the splat);
* the extent is the diagonal of the box of the live splats' means (INRIA:
  the cameras' spread);
* a split keeps no parent: the rows are the kept splats (alive and not
  split) in order, the clones, the first children, the second children,
  then dead splats (zero mean, identity rotation, log-scale -12, logit
  opacity -15, zero colour) up to a multiple of ``pad_multiple``;
* the split's samples are drawn on the host, ``np.random.default_rng(
  seed)``, two (S, 3) standard normals in order, the first for the first
  children, so that a seed gives one placement on every side;
* Adam restarts from zero moments and a zero count after a round (INRIA
  keeps the survivors' moments); no screen-size prune.

Everything is float32 on the scene's device.  Nothing here imports the
program under test; the training step is :mod:`render`'s.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from splatbench.reference import render

DEAD = {"means": 0.0, "log_scales": -12.0, "logit_opacities": -15.0,
        "sh": 0.0}


def opacity(logit: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-logit))


def rotation(q: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) rotation of (N, 4) scalar-first quaternions, normalised
    first."""
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=1), min=1e-12)[:, None]
    w, x, y, z = q.unbind(1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], 1).reshape(-1, 3, 3)


def decide(raw: dict, grad_mean: torch.Tensor, recipe: dict) -> dict:
    """The round's masks over the splats: ``alive``, ``clone``, ``split``,
    ``keep`` (alive and not split), and the split threshold used."""
    alive = opacity(raw["logit_opacities"]) > recipe["min_opacity"]
    thr = recipe.get("split_scale_threshold")
    if thr is None:
        pts = raw["means"][alive] if bool(alive.any()) else raw["means"]
        extent = (float(torch.linalg.vector_norm(
            pts.amax(0) - pts.amin(0))) if len(pts) else 1.0)
        thr = 0.01 * max(extent, 1e-6)
    needs = alive & (grad_mean > recipe["grad_threshold"])
    large = torch.exp(raw["log_scales"]).amax(1) > thr
    return {"alive": alive, "clone": needs & ~large, "split": needs & large,
            "keep": alive & ~(needs & large), "threshold": thr}


def draws(seed: int, count: int, device) -> torch.Tensor:
    """The split's (2, S, 3) standard normals."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.stack([
        rng.normal(size=(count, 3)).astype(np.float32) for _ in range(2)
    ])).to(device)


def pad(raw: dict, multiple: int) -> tuple[dict, int]:
    """``raw`` with dead splats appended up to a multiple of ``multiple``,
    and how many were appended."""
    n = raw["means"].shape[0]
    extra = (-n) % multiple
    out = {}
    for k, v in raw.items():
        tail = torch.full((extra,) + v.shape[1:], DEAD.get(k, 0.0),
                          dtype=v.dtype, device=v.device)
        if k == "quats":
            tail[:, 0] = 1.0
        out[k] = torch.cat([v, tail])
    return out, extra


def densify(raw: dict, grad_mean: torch.Tensor, recipe: dict, *,
            seed: int = 0) -> tuple[dict, dict, torch.Tensor]:
    """One ADC round: the new raw leaves, the counts (``kept``,
    ``cloned``, ``split``, ``pruned``, ``padded``, ``n``) and, for each
    new row, the row of ``raw`` it came from (-1 for padding)."""
    m = decide(raw, grad_mean, recipe)
    keep = torch.nonzero(m["keep"]).squeeze(1)
    clone = torch.nonzero(m["clone"]).squeeze(1)
    split = torch.nonzero(m["split"]).squeeze(1)
    src = torch.cat([keep, clone, split, split])
    new = {k: v[src] for k, v in raw.items()}
    if len(split):
        scales = torch.exp(raw["log_scales"][split])
        rot = rotation(raw["quats"][split])
        eps = draws(seed, len(split), raw["means"].device)
        offsets = torch.cat([torch.einsum("nij,nj->ni", rot, scales * e)
                             for e in eps])
        at = len(keep) + len(clone)
        new["means"][at:] = new["means"][at:] + offsets
        new["log_scales"][at:] = (new["log_scales"][at:]
                                  - math.log(recipe["split_factor"]))
    new, extra = pad(new, int(recipe["pad_multiple"]))
    src = torch.cat([src, torch.full((extra,), -1, dtype=src.dtype,
                                     device=src.device)])
    stats = {"kept": len(keep), "cloned": len(clone), "split": len(split),
             "pruned": int((~m["alive"]).sum()), "padded": extra,
             "n": new["means"].shape[0]}
    return new, stats, src


def carry_moments(adam: render.Adam, src: torch.Tensor) -> render.Adam:
    """``adam``'s moments and count carried through a round to the new
    rows (zeros for padding): INRIA's way, not the recipe's; a fault of the
    check."""
    live, at = src >= 0, src.clamp(min=0)
    for k in adam.m:
        mask = live.reshape((-1,) + (1,) * (adam.m[k].dim() - 1))
        adam.m[k] = torch.where(mask, adam.m[k][at], 0.0)
        adam.v[k] = torch.where(mask, adam.v[k][at], 0.0)
    return adam


def steps(raw: dict, views, targets, recipe: dict, count: int, *,
          lr: float, lr_scales: dict, adam: render.Adam | None = None,
          feature_dtype=None, work: bool = False) -> dict:
    """``count`` training steps from ``raw``: the losses, the leaves after
    them, each leaf's gradient norm at the first step, the mean of the
    per-splat norm of the means' gradient over the steps (the round's
    statistic), the first forward's work, and the optimizer."""
    adam = adam or render.Adam(raw, lr, lr_scales)
    losses, gnorm, first_work = [], None, None
    gsum = torch.zeros(raw["means"].shape[0], device=raw["means"].device)
    for s in range(count):
        loss, grads, w = render.loss_and_grads(
            raw, views, targets, recipe, feature_dtype=feature_dtype,
            count=work and s == 0)
        if s == 0:
            gnorm = {k: float(torch.linalg.vector_norm(g))
                     for k, g in grads.items()}
            first_work = w
        gsum = gsum + torch.linalg.vector_norm(grads["means"], dim=1)
        losses.append(float(loss))
        raw = adam.step(raw, grads)
    return {"losses": losses, "raw": raw, "gnorm": gnorm,
            "grad_mean": gsum / count, "work": first_work, "adam": adam}


def fit(raw: dict, views, targets, recipe: dict, adc: dict, *, total: int,
        interval: int, lr: float, lr_scales: dict) -> dict:
    """``total`` training steps from ``raw`` with an ADC round after every
    ``interval`` of them (none after the last), Adam restarted after each:
    the losses, the final leaves and each round's counts."""
    losses, log, done = [], [], 0
    while done < total:
        n = min(interval, total - done)
        out = steps(raw, views, targets, recipe, n, lr=lr,
                    lr_scales=lr_scales)
        losses += out["losses"]
        raw, done = out["raw"], done + n
        if done < total:
            raw, stats, _ = densify(raw, out["grad_mean"], adc,
                                    seed=adc.get("seed", 0))
            log.append(stats)
    return {"losses": losses, "raw": raw, "log": log}

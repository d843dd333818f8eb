"""The numbers the correctness check compares, and the verdict.

A frame is judged against the reference's image at the same pose: the
largest absolute pixel difference and the mean squared difference, the
worst over the checked frames.  A training run is judged by its first
steps against the reference's: each step's loss as a share of the
reference's, and each leaf's parameter change after the steps, the gap
between the two norms as a share of the reference's norm of that leaf or
of the median leaf, whichever is larger (the worst leaf counts).  A leaf
whose reference gradient at the first step is under a thousandth of the
median leaf's moves under Adam by round-off alone and is left out.

Each number has its limit in ``limits/<workload>.json``; a run is
correct when every number is finite and within its limit.
"""

from __future__ import annotations

import math

import torch

# a leaf with a first gradient under this share of the median leaf's is
# left out of the change comparison
STILL_LEAF = 1e-3


def frame_numbers(pairs) -> dict:
    """``pairs``: (program image, reference image) of each checked frame,
    or (None, reference) for a frame that never came."""
    max_abs, mse = 0.0, 0.0
    for img, ref in pairs:
        if img is None:
            return {"img_max_abs": math.inf, "img_mse": math.inf}
        d = (img.to(torch.float32) - ref).abs()
        max_abs = max(max_abs, float(d.max()))
        mse = max(mse, float((d * d).mean()))
    return {"img_max_abs": max_abs, "img_mse": mse}


def fit_numbers(prog_losses, ref_losses, prog_raw: dict, ref_raw: dict,
                raw0: dict, ref_grad_norm: dict) -> dict:
    """Loss gap (worst step) and change gap (worst leaf)."""
    loss_gap = max(abs(float(p) - float(r)) / abs(float(r))
                   for p, r in zip(prog_losses, ref_losses))
    if len(prog_losses) != len(ref_losses):
        loss_gap = math.inf
    med_g = sorted(ref_grad_norm.values())[len(ref_grad_norm) // 2]
    leaves = [k for k, g in ref_grad_norm.items() if g >= STILL_LEAF * med_g]
    dref = {k: float(torch.linalg.vector_norm(ref_raw[k] - raw0[k]))
            for k in leaves}
    dprog = {k: float(torch.linalg.vector_norm(
        prog_raw[k].to(raw0[k].device) - raw0[k])) for k in leaves}
    med = sorted(dref.values())[len(dref) // 2]
    change_gap = max(abs(dprog[k] - dref[k]) / max(dref[k], med)
                     for k in leaves)
    return {"loss_gap": loss_gap, "change_gap": change_gap}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for every limited number."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, math.nan)
        checks[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, checks

"""Plain PyTorch reference of the tiled 3DGS frame and training step.

The semantics are those of the renderer the benchmark measures
(Kerbl et al. 2023, with the conventions of this repository's reference
renderer, PARITY.md): an orbit camera, EWA projection with the truncated
Jacobian and a 0.3 px low-pass, degree-3 SH colour, CEIL-quantized 1/8-px
boxes binned on 32 x 32 tiles, pairs sorted by (tile, f32 depth, index),
and front-to-back compositing with alpha = min(0.99, op * exp(power)),
pairs below 1/255 or outside the box skipped.  Inference (:func:`render`)
stops a tile after a batch of 128 pairs (batches at absolute multiples of
128 in the sorted pairs) once every pixel of the tile has T < 1/255;
training (:func:`loss_and_grads`) walks every pair.

Per-gaussian quantities are computed with the same float32 operations in
the same order as the formulas are written in the port's sources, so the
view matrix and the depths come out bit for bit and the pairs sort alike;
compositing runs vectorised over whole tiles in blocks (a product scan
per pixel), in another order than a per-pixel loop, so images agree to
float32 rounding.  ``feature_dtype`` rounds the per-pair features to a
lower precision: the control of the correctness check.

Nothing here imports the program under test, and nothing takes a tensor
the program made: the scene leaves and the pose are the benchmark's.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)

# the renderer's constants (the defaults of its RenderConfig)
LOWPASS = 0.3
ALPHA_CLAMP = 0.99
ALPHA_MIN = 1.0 / 255.0
SIGMA_CUTOFF = 3.0
CHUNK = 128
R15_MAX = 32767
# (pixel, pair) evaluations a compositing block holds at once
BLOCK_ELEMS = 1 << 25
MAX_PAIR_CHUNK = 4096

# training has no tile exit: a pixel's result depends only on the pairs
# whose box holds it, in depth order, so the reference bins its training
# walk on finer tiles (exactly the same sums, far fewer (pixel, pair)
# evaluations on the silhouettes)
TRAIN_TILE = 8

# the training loss's SSIM window
SSIM_WINDOW, SSIM_SIGMA, SSIM_C1, SSIM_C2 = 11, 1.5, 0.01 ** 2, 0.03 ** 2
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
RAW_LEAVES = ("means", "quats", "log_scales", "logit_opacities", "sh")


# -- camera -------------------------------------------------------------

def _normalize(v):
    return v / torch.clamp(torch.linalg.vector_norm(v), min=1e-12)


def _rotate(v, axis, angle):
    k = _normalize(axis)
    c, s = torch.cos(angle), torch.sin(angle)
    return (v * c + torch.linalg.cross(k, v) * s
            + k * torch.dot(k, v) * (1.0 - c))


def eye(pose: dict) -> torch.Tensor:
    """The orbit camera's centre: yaw about ``up``, then pitch about
    ``up x position`` (the base position), with the pole guard."""
    pos, tgt, up = pose["position"], pose["target"], pose["up"]
    pitch = pose["pitch"]
    cos_angle = torch.dot(_normalize(pos - tgt), up)
    pitch = torch.where(cos_angle * torch.sign(pitch) > 0.99,
                        torch.zeros_like(pitch), pitch)
    p = _rotate(pos - tgt, up, pose["yaw"])
    p = _rotate(p, torch.linalg.cross(up, pos), pitch)
    return p + tgt


def view_matrix(pose: dict) -> torch.Tensor:
    """Right-handed look-at from the orbit's eye to the target."""
    e, tgt, up = eye(pose), pose["target"], pose["up"]
    f = _normalize(tgt - e)
    s = _normalize(torch.linalg.cross(f, up))
    u = torch.linalg.cross(s, f)
    last = torch.zeros(4, dtype=torch.float32, device=e.device)
    last[3] = 1.0
    return torch.stack([
        torch.cat([s, -torch.dot(s, e)[None]]),
        torch.cat([u, -torch.dot(u, e)[None]]),
        torch.cat([-f, torch.dot(f, e)[None]]),
        last]).to(torch.float32)


# -- projection ---------------------------------------------------------

def _sh_color(shs, x, y, z):
    """Degree-3 SH colour (+0.5) from 48 coefficient columns
    (``shs[3 k + c]``) and the unit view direction."""
    def band(k):
        return shs[3 * k], shs[3 * k + 1], shs[3 * k + 2]

    out = [SH_C0 * c for c in band(0)]
    for i, c in enumerate(band(1)):
        out[i] = out[i] - SH_C1 * y * c
    for i, c in enumerate(band(2)):
        out[i] = out[i] + SH_C1 * z * c
    for i, c in enumerate(band(3)):
        out[i] = out[i] - SH_C1 * x * c
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    basis2 = (SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2.0 * zz - xx - yy),
              SH_C2[3] * xz, SH_C2[4] * (xx - yy))
    for k, bk in enumerate(basis2):
        for i, c in enumerate(band(4 + k)):
            out[i] = out[i] + bk * c
    basis3 = (SH_C3[0] * y * (3.0 * xx - yy), SH_C3[1] * xy * z,
              SH_C3[2] * y * (4.0 * zz - xx - yy),
              SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
              SH_C3[4] * x * (4.0 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
              SH_C3[6] * x * (xx - 3.0 * yy))
    for k, bk in enumerate(basis3):
        for i, c in enumerate(band(9 + k)):
            out[i] = out[i] + bk * c
    return out[0] + 0.5, out[1] + 0.5, out[2] + 0.5


def project(leaves: dict, pose: dict) -> dict:
    """Per-gaussian screen quantities of a scene (``means``, ``quats``,
    ``scales``, ``opacities``, ``sh`` as activated float32 leaves) at a
    pose: depth, centre (cx, cy), conic (a, b, c), box radii (rx, ry),
    colour (r, g, b), opacity, visible.  Differentiable in the leaves."""
    view = view_matrix(pose)
    h, w = pose["h"], pose["w"]
    htany = torch.tan(pose["fovy"] / 2)
    focal = h / (2.0 * htany)
    cx0 = torch.full((), w / 2, dtype=torch.float32, device=view.device)
    cy0 = torch.full((), h / 2, dtype=torch.float32, device=view.device)
    m, q, sc, sh = leaves["means"], leaves["quats"], leaves["scales"], \
        leaves["sh"]
    opacity = leaves["opacities"]
    mx, my, mz = m[:, 0], m[:, 1], m[:, 2]
    qw, qx, qy, qz = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    sx_, sy_, sz_ = sc[:, 0], sc[:, 1], sc[:, 2]
    shs = tuple(sh[:, k, c] for k in range(16) for c in range(3))

    # world covariance R diag(s^2) R^T as six columns
    inv = 1.0 / torch.clamp(
        torch.sqrt(qw * qw + qx * qx + qy * qy + qz * qz), min=1e-12)
    qw, qx, qy, qz = qw * inv, qx * inv, qy * inv, qz * inv
    m00 = (1 - 2 * (qy * qy + qz * qz)) * sx_
    m01 = (2 * (qx * qy - qw * qz)) * sy_
    m02 = (2 * (qx * qz + qw * qy)) * sz_
    m10 = (2 * (qx * qy + qw * qz)) * sx_
    m11 = (1 - 2 * (qx * qx + qz * qz)) * sy_
    m12 = (2 * (qy * qz - qw * qx)) * sz_
    m20 = (2 * (qx * qz - qw * qy)) * sx_
    m21 = (2 * (qy * qz + qw * qx)) * sy_
    m22 = (1 - 2 * (qx * qx + qy * qy)) * sz_
    xx = m00 * m00 + m01 * m01 + m02 * m02
    xy = m00 * m10 + m01 * m11 + m02 * m12
    xz = m00 * m20 + m01 * m21 + m02 * m22
    yy = m10 * m10 + m11 * m11 + m12 * m12
    yz = m10 * m20 + m11 * m21 + m12 * m22
    zz = m20 * m20 + m21 * m21 + m22 * m22

    px = view[0, 0] * mx + view[0, 1] * my + view[0, 2] * mz + view[0, 3]
    py = view[1, 0] * mx + view[1, 1] * my + view[1, 2] * mz + view[1, 3]
    pz = view[2, 0] * mx + view[2, 1] * my + view[2, 2] * mz + view[2, 3]
    u = (view[0, 0], view[0, 1], view[0, 2])
    v = (view[1, 0], view[1, 1], view[1, 2])

    def quad(p, r):
        return (xx * (p[0] * r[0]) + yy * (p[1] * r[1]) + zz * (p[2] * r[2])
                + xy * (p[0] * r[1] + p[1] * r[0])
                + xz * (p[0] * r[2] + p[2] * r[0])
                + yz * (p[1] * r[2] + p[2] * r[1]))

    sxp = focal / pz
    syp = focal / pz
    a = (sxp * sxp) * quad(u, u) + LOWPASS
    b = (sxp * syp) * quad(u, v)
    c = (syp * syp) * quad(v, v) + LOWPASS
    det = a * c - b * b
    inv_det = 1.0 / torch.where(det > 0, det, torch.ones_like(det))
    conic = (c * inv_det, -b * inv_det, a * inv_det)

    cut2 = torch.full_like(opacity, SIGMA_CUTOFF) ** 2
    qmax = 2.0 * torch.log(torch.clamp(opacity / ALPHA_MIN, min=1e-12))
    cut2 = torch.minimum(cut2, torch.clamp(qmax, min=0.0))
    rx = torch.sqrt(cut2 * torch.clamp(a, min=0.0))
    ry = torch.sqrt(cut2 * torch.clamp(c, min=0.0))

    cx = cx0 + focal * (px / -pz)
    cy = cy0 - focal * (py / -pz)
    depth = -pz
    e = eye(pose)
    rdx, rdy, rdz = mx - e[0], my - e[1], mz - e[2]
    rinv = 1.0 / torch.clamp(torch.sqrt(rdx * rdx + rdy * rdy + rdz * rdz),
                             min=1e-12)
    color = _sh_color(shs, rdx * rinv, rdy * rinv, rdz * rinv)
    visible = ((depth > pose["znear"]) & (det > 0)
               & (cx + rx > 0) & (cx - rx < w) & (cy + ry > 0) & (cy - ry < h)
               & torch.isfinite(cx) & torch.isfinite(cy)
               & (opacity >= ALPHA_MIN))
    return {"depth": depth, "cx": cx, "cy": cy, "conic": conic, "rx": rx,
            "ry": ry, "color": color, "opacity": opacity, "visible": visible}


# -- binning ------------------------------------------------------------

def _box_radius(r):
    """CEIL-quantized 1/8-px radius (+inf where the 15-bit field
    saturates; 0 for NaN)."""
    q = torch.clamp(torch.ceil(r * 8.0), 0.0, float(R15_MAX))
    q = torch.where(torch.isnan(q), torch.zeros_like(q), q)
    return torch.where(q == R15_MAX, math.inf, q * 0.125)


@torch.no_grad()
def bin_pairs(proj: dict, h: int, w: int, tile: int) -> dict:
    """Every (gaussian, tile) pair of the visible gaussians' boxes, sorted
    by tile, then depth, then gaussian index: ``gauss`` and ``tile`` (K,)
    int64, ``start``/``end`` (T,) int64 ranges, ``rx2``/``ry2`` (N,)
    squared box radii, the grid and the visible count."""
    ntx, nty = -(-w // tile), -(-h // tile)
    vis = proj["visible"]
    rx, ry = _box_radius(proj["rx"].detach()), _box_radius(proj["ry"].detach())
    cx, cy = proj["cx"].detach(), proj["cy"].detach()

    def edge(v, nt):
        f = torch.clamp(torch.floor(v / tile), 0, nt - 1)
        return torch.where(vis, f, torch.zeros_like(f)).to(torch.int64)

    tx0, tx1 = edge(cx - rx, ntx), edge(cx + rx, ntx)
    ty0, ty1 = edge(cy - ry, nty), edge(cy + ry, nty)
    sw = tx1 - tx0 + 1
    counts = torch.where(vis, sw * (ty1 - ty0 + 1), torch.zeros_like(sw))
    gauss = torch.repeat_interleave(
        torch.arange(counts.numel(), device=counts.device), counts)
    first = torch.cumsum(counts, 0) - counts
    r = torch.arange(gauss.numel(), device=gauss.device) - first[gauss]
    dy = torch.div(r, sw[gauss], rounding_mode="floor")
    tile_id = ((ty0[gauss] + dy) * ntx + tx0[gauss]
               + (r - dy * sw[gauss]))
    # stable sorts: by depth, then by tile; pairs start in gaussian order
    order = torch.sort(proj["depth"].detach()[gauss], stable=True)[1]
    order = order[torch.sort(tile_id[order], stable=True)[1]]
    gauss, tile_id = gauss[order], tile_id[order]
    edges = torch.searchsorted(
        tile_id, torch.arange(ntx * nty + 1, device=tile_id.device))
    return {"gauss": gauss, "tile": tile_id, "start": edges[:-1],
            "end": edges[1:], "rx2": rx * rx, "ry2": ry * ry,
            "ntx": ntx, "nty": nty, "tile_px": tile, "h": h, "w": w,
            "visible": int(vis.sum())}


def pair_features(proj: dict, bins: dict, feature_dtype=None):
    """(11, K) features of the sorted pairs: cx, cy, the prescaled conic
    (-a/2, -b, -c/2), clipped colour, opacity, rx^2, ry^2.  With
    ``feature_dtype`` the per-gaussian rows are rounded to that type
    first (the control)."""
    a, b, c = proj["conic"]
    rows = [proj["cx"], proj["cy"], -0.5 * a, -b, -0.5 * c,
            *(torch.clamp(col, 0.0, 1.0) for col in proj["color"]),
            proj["opacity"]]
    if feature_dtype is not None:
        rows = [r.to(feature_dtype).to(torch.float32) for r in rows]
    rows += [bins["rx2"], bins["ry2"]]
    return torch.stack(rows)[:, bins["gauss"]]


# -- compositing --------------------------------------------------------

def _tile_blocks(start, end, pixels: int):
    """Blocks of tiles for the vectorised walk, longest first: (tile ids,
    padded walk length, pair chunk).  A tile's walk starts at its first
    pair rounded down to a multiple of CHUNK."""
    base = start - start % CHUNK
    length = torch.where(end > start, end - base, torch.zeros_like(end))
    order = torch.argsort(length, descending=True)
    lens = length[order].tolist()
    blocks, i = [], 0
    while i < len(lens) and lens[i] > 0:
        top = lens[i]
        kc = min(-(-top // CHUNK) * CHUNK, MAX_PAIR_CHUNK)
        nb = max(1, BLOCK_ELEMS // (kc * pixels))
        j = i + 1
        while j < len(lens) and j - i < nb and lens[j] > 0:
            j += 1
        blocks.append((order[i:j], top, kc))
        i = j
    return blocks, base


def _chunk(f, px, py, t_in, c_in, alive, valid, last, inside, *,
           train: bool, count: bool):
    """Composite one pair chunk of a block of tiles.  f: (11, B, kc) pair
    features; px/py: (B, P); t_in/c_in: (B, P) transmittance and (B, P, 3)
    colour so far; alive: (B,) tiles still walking; valid: (B, kc) real
    pairs; last: (B, kc) the last pair of a batch or of the tile; inside:
    (B, P) the pixels inside the image, which the work counts."""
    cx, cy, a2, b2, c2, r, g, b, op, rx2, ry2 = (x[..., None] for x in f)
    dx = px[:, None, :] - cx
    dy = cy - py[:, None, :]
    dx2 = dx * dx
    dy2 = dy * dy
    power = a2 * dx2 + c2 * dy2 + b2 * (dx * dy)
    alpha = torch.clamp(op * torch.exp(power), max=ALPHA_CLAMP)
    keep = ((alpha >= ALPHA_MIN) & (dx2 <= rx2) & (dy2 <= ry2)
            & valid[..., None])
    a_eff = torch.where(keep, alpha, torch.zeros_like(alpha))
    scan = torch.cumprod(1.0 - a_eff, dim=1)
    walked = alive[:, None] & valid
    if not train:
        # the whole-tile exit after a batch once every pixel has T < 1/255
        tmax = (t_in[:, None, :] * scan).amax(dim=2)
        stop = last & valid & (tmax < ALPHA_MIN)
        before = (torch.cumsum(stop.to(torch.int32), 1) - stop.to(
            torch.int32)) > 0
        walked = walked & ~before
        a_eff = torch.where(walked[..., None], a_eff,
                            torch.zeros_like(a_eff))
        scan = torch.cumprod(1.0 - a_eff, dim=1)
        alive = alive & ~(stop & walked).any(dim=1)
    t_excl = t_in[:, None, :] * torch.cat(
        [torch.ones_like(scan[:, :1]), scan[:, :-1]], dim=1)
    weight = a_eff * t_excl
    rgb = torch.stack([r[..., 0], g[..., 0], b[..., 0]], dim=-1)
    c_out = c_in + torch.einsum("bkp,bkc->bpc", weight, rgb)
    t_out = t_in * scan[:, -1, :]
    work = None
    if count:
        # what each pixel needs: pairs until its own T falls below the
        # exit threshold (inference) or to exactly 0 (training)
        t_prev = t_excl.detach()
        need = (walked[..., None] & inside[:, None, :]
                & ((t_prev > 0) if train else (t_prev >= ALPHA_MIN)))
        per_px = need.sum(dim=1)                                # (B, P)
        box = need & (dx2 <= rx2) & (dy2 <= ry2)
        work = torch.stack([need.sum(), (need & keep).sum(), box.sum(),
                            per_px.amax(dim=1).sum()])
    return t_out, c_out, alive, work


def composite(feats, bins: dict, *, train: bool, count: bool = False):
    """(T, P, 3) colour and (T, P) transmittance of every tile pixel, and
    with ``count`` the work each pixel needed: (needed (pixel, pair)
    evaluations, the kept ones, those inside the pair's box, pairs the
    tiles needed)."""
    tile = bins["tile_px"]
    ntx, nty = bins["ntx"], bins["nty"]
    nt, p = ntx * nty, tile * tile
    dev = feats.device
    lin = torch.arange(p, device=dev)
    tid = torch.arange(nt, device=dev)
    pxf = ((tid % ntx)[:, None] * tile + lin % tile).to(torch.float32)
    pyf = ((tid // ntx)[:, None] * tile + lin // tile).to(torch.float32)
    inside_all = (pxf < bins["w"]) & (pyf < bins["h"])
    start, end = bins["start"], bins["end"]
    kp = feats.shape[1]
    color = torch.zeros((nt, p, 3), dtype=torch.float32, device=dev)
    trans = torch.ones((nt, p), dtype=torch.float32, device=dev)
    work = torch.zeros(4, dtype=torch.int64, device=dev)
    blocks, base = _tile_blocks(start, end, p)
    for ids, top, kc in blocks:
        lane = torch.arange(kc, device=dev)
        px, py = pxf[ids], pyf[ids]
        s, e, b0 = start[ids, None], end[ids, None], base[ids, None]
        t_c = torch.ones((ids.numel(), p), dtype=torch.float32, device=dev)
        c_c = torch.zeros((ids.numel(), p, 3), dtype=torch.float32,
                          device=dev)
        alive = torch.ones(ids.numel(), dtype=torch.bool, device=dev)
        inside = inside_all[ids]
        for j0 in range(0, top, kc):
            # nothing left to walk: every tile of the block has exited
            # (inference), or every pixel inside the image has T exactly
            # 0, after which every pair adds exact zeros to the image and
            # to every gradient (training)
            if j0 and not bool(alive.any() if not train else
                               ((t_c != 0) & inside).any()):
                break
            k = b0 + j0 + lane
            valid = (k >= s) & (k < e)
            last = (((k + 1) % CHUNK) == 0) | (k == e - 1)
            f = feats[:, k.clamp(0, kp - 1)]
            args = (f, px, py, t_c, c_c, alive, valid, last, inside)
            kw = {"train": train, "count": count}
            if train and torch.is_grad_enabled():
                t_c, c_c, alive, wk = checkpoint(
                    _chunk, *args, use_reentrant=False, **kw)
            else:
                t_c, c_c, alive, wk = _chunk(*args, **kw)
            if count:
                work = work + wk.to(torch.int64)
        color = color.index_put((ids,), c_c)
        trans = trans.index_put((ids,), t_c)
    return color, trans, work


def untile(x, bins: dict, h: int, w: int):
    """(T, P, ...) tile pixels -> (H, W, ...) image."""
    t, ntx, nty = bins["tile_px"], bins["ntx"], bins["nty"]
    rest = x.shape[2:]
    img = x.reshape(nty, ntx, t, t, *rest).transpose(1, 2)
    return img.reshape(nty * t, ntx * t, *rest)[:h, :w]


def render(leaves: dict, pose: dict, tile: int, *, feature_dtype=None,
           count: bool = False):
    """The inference frame: float32 (H, W, 3) image, and with ``count``
    the work its pixels needed (the dict ``roofline`` reads)."""
    with torch.no_grad():
        proj = project(leaves, pose)
        bins = bin_pairs(proj, pose["h"], pose["w"], tile)
        feats = pair_features(proj, bins, feature_dtype)
        color, trans, work = composite(feats, bins, train=False, count=count)
        img = torch.clamp(untile(color, bins, pose["h"], pose["w"]), 0.0, 1.0)
    if not count:
        return img
    return img, _work_dict(work, bins, leaves)


def _work_dict(work, bins: dict, leaves: dict) -> dict:
    evals, kept, box, tile_pairs = (int(x) for x in work.tolist())
    return {"n": int(leaves["means"].shape[0]), "visible": bins["visible"],
            "pairs": int(bins["gauss"].numel()), "tile_pairs": tile_pairs,
            "tiles": bins["ntx"] * bins["nty"], "evals": evals,
            "kept": kept, "box": box}


# -- training -----------------------------------------------------------

def raw_from_scene(leaves: dict) -> dict:
    """Unconstrained leaves: log scales, logit opacities (clamped into
    [1e-5, 1 - 1e-5]), the rest as given."""
    op = torch.clamp(leaves["opacities"], 1e-5, 1.0 - 1e-5)
    return {"means": leaves["means"].clone(), "quats": leaves["quats"].clone(),
            "log_scales": torch.log(torch.clamp(leaves["scales"], min=1e-12)),
            "logit_opacities": torch.log(op) - torch.log1p(-op),
            "sh": leaves["sh"].clone()}


def scene_from_raw(raw: dict) -> dict:
    return {"means": raw["means"], "quats": raw["quats"],
            "scales": torch.exp(raw["log_scales"]),
            "opacities": torch.sigmoid(raw["logit_opacities"]),
            "sh": raw["sh"]}


def _blur(x, taps):
    """(H, W, C) separable blur with zero padding."""
    r = taps.numel() // 2
    h, w = x.shape[:2]
    xp = torch.nn.functional.pad(x, (0, 0, r, r))
    x = sum(taps[i] * xp[:, i:i + w] for i in range(taps.numel()))
    xp = torch.nn.functional.pad(x, (0, 0, 0, 0, r, r))
    return sum(taps[i] * xp[i:i + h] for i in range(taps.numel()))


def ssim(a, b):
    """Mean gaussian-windowed SSIM of two (H, W, C) images."""
    x = torch.arange(SSIM_WINDOW, dtype=torch.float32,
                     device=a.device) - SSIM_WINDOW // 2
    k = torch.exp(-0.5 * (x / SSIM_SIGMA) ** 2)
    taps = k / torch.sum(k)
    mu_a, mu_b = _blur(a, taps), _blur(b, taps)
    var_a = _blur(a * a, taps) - mu_a * mu_a
    var_b = _blur(b * b, taps) - mu_b * mu_b
    cov = _blur(a * b, taps) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + SSIM_C1) * (2 * cov + SSIM_C2)
         / ((mu_a * mu_a + mu_b * mu_b + SSIM_C1) * (var_a + var_b + SSIM_C2)))
    return torch.mean(s)


def train_image(leaves: dict, pose: dict, *, feature_dtype=None,
                count: bool = False):
    """The training forward's image (every pair walked), differentiable."""
    proj = project(leaves, pose)
    bins = bin_pairs(proj, pose["h"], pose["w"], TRAIN_TILE)
    feats = pair_features(proj, bins, feature_dtype)
    color, _, work = composite(feats, bins, train=True, count=count)
    img = torch.clamp(untile(color, bins, pose["h"], pose["w"]), 0.0, 1.0)
    return img, (_work_dict(work, bins, leaves) if count else None)


def view_loss(img, target, l1_weight: float, dssim_weight: float):
    err = img - target
    loss = torch.mean(err * err) + l1_weight * torch.mean(torch.abs(err))
    if dssim_weight:
        loss = loss + dssim_weight * (1.0 - ssim(img, target))
    return loss


def loss_and_grads(raw: dict, poses, targets, recipe: dict, *,
                   feature_dtype=None, count: bool = False):
    """Mean loss over ``poses`` and its gradient in each raw leaf.  With
    ``count``, also the work of each view's forward walk."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in raw.items()}
    total, works = None, []
    for pose, target in zip(poses, targets):
        # one backward a view keeps one view's graph alive at a time
        img, work = train_image(scene_from_raw(leaves), pose,
                                feature_dtype=feature_dtype, count=count)
        loss = view_loss(img, target, recipe["l1_weight"],
                         recipe["dssim_weight"]) / len(poses)
        loss.backward()
        total = loss.detach() if total is None else total + loss.detach()
        works.append(work)
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             for k, v in leaves.items()}
    return total, grads, works


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8) per leaf with a constant step
    size per leaf, float32 bias corrections."""

    def __init__(self, raw: dict, lr: float, lr_scales: dict):
        self.m = {k: torch.zeros_like(v) for k, v in raw.items()}
        self.v = {k: torch.zeros_like(v) for k, v in raw.items()}
        self.count = 0
        self.step_size = {k: float(np.float32(-lr * lr_scales[k]))
                          for k in raw}

    def step(self, raw: dict, grads: dict) -> dict:
        self.count += 1
        n = np.float32(self.count)
        c1 = float(1 - np.float32(ADAM_B1) ** n)
        c2 = float(1 - np.float32(ADAM_B2) ** n)
        out = {}
        for k, g in grads.items():
            self.m[k] = (1 - ADAM_B1) * g + ADAM_B1 * self.m[k]
            self.v[k] = (1 - ADAM_B2) * (g * g) + ADAM_B2 * self.v[k]
            d = (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + ADAM_EPS)
            out[k] = raw[k].detach() + d * self.step_size[k]
        return out

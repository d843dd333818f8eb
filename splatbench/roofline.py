"""The yardstick of the per-layer shares: the card's published peaks and
the operations and bytes a frame or a training step needs.

Peaks: NVIDIA's H100 SXM data sheet (dense, at the full 700 W) for the
memory rate and the float32 rate outside the tensor cores; the
special-function rate is 16 results per SM per clock at compute
capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
throughput) on 132 SMs at the 1980 MHz maximum SM clock.

Work comes only from the inputs, as the reference counts it
(``reference.render``'s work dicts): the projection of every gaussian,
the sorted (gaussian, tile) pairs, and for each pixel inside the image
the pairs up to where its own exit rule stops it (T < 1/255 in a frame,
T exactly 0 in training, where later pairs add exact zeros); of those, a
pair's alpha is work only at the pixels inside its box, which a kernel
may skip the rest of without evaluating them.  Each input
byte is counted once and each output byte written once, whatever an
implementation reads again, so no share can pass 100% honestly.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SFU_OPS_PER_S = 16 * 132 * 1.98e9

# one pair's alpha at one pixel: dx, dy, three products, the quadratic
# form (3 mul + 2 add), the opacity product, the clamp, the alpha_min
# test, the box test; its exp is one SFU operation
ALPHA_OPS, ALPHA_SFU = 14, 1
# per kept (pixel, pair): K2's weight, 3 colour mul + add, T update (sub,
# mul); K3's clamp, weight, 3 colour mul + add, T update and logT add,
# with log1p on the SFU; K4's clamp, lt_i, min, gc (3 mul + 2 add),
# weight, dalpha (2 mul, 2 sub), dpower, 6 geometry and 3 colour mul +
# add, D update, with log1p, exp and the division on the SFU
K2_KEPT_OPS, K2_KEPT_SFU = 9, 0
K3_KEPT_OPS, K3_KEPT_SFU = 10, 1
K4_KEPT_OPS, K4_KEPT_SFU = 33, 3
# a visible gaussian's features as compositing needs them, read once:
# centre (2), prescaled conic (3), colour (3), opacity, squared box
# radii (2); and a needed pair's entry in its tile's list: its gaussian
FEATURE_BYTES = 11 * 4
PAIR_INDEX_BYTES = 4
# a pair's sort record: its tile and depth key, its gaussian
PAIR_KEY_BYTES = 8 + 4
# a gaussian's 59 float32 leaves (means 3, quaternion 4, scales 3,
# opacity, 48 SH) and its projected record (the features above, depth)
GAUSS_BYTES = 59 * 4
PROJ_BYTES = 12 * 4
# the projection of one gaussian, counted on reference.project: the
# covariance (~85), the camera-space position (18), the three quadratic
# forms (60), conic, radii and centre (~33), the degree-3 SH colour and
# its direction (~150), the visibility test (12); square roots, the log,
# the reciprocals and the trigonometry-free rest on the SFU (6).  Its
# backward takes twice that.
PROJ_OPS, PROJ_SFU = 360, 6
# per pixel of the training loss: L2 and L1 (6), D-SSIM's five separable
# 11-tap blurs of three channels (660) and its ratio (~30); backward twice
SSIM_OPS_PX = 700
# Adam per parameter: read parameter, gradient, two moments; write the
# parameter and the moments
ADAM_BYTES = 7 * 4


def least_seconds(nbytes: float, ops: float, sfu: float) -> tuple[float, str]:
    """The least time the card could take and what bounds it: bytes over
    the memory rate, float32 operations over their rate, special-function
    operations over theirs."""
    terms = {"bytes": nbytes / HBM_BYTES_PER_S,
             "fp32": ops / FP32_OPS_PER_S,
             "sfu": sfu / SFU_OPS_PER_S}
    which = max(terms, key=terms.get)
    return terms[which], which


def _add(*parts):
    return tuple(sum(p[i] for p in parts) for i in range(3))


def _pairs_in(w: dict) -> int:
    """A compositing walk's input: the visible gaussians' features, the
    needed pairs' entries, each tile's range."""
    return (w["visible"] * FEATURE_BYTES + w["tile_pairs"] * PAIR_INDEX_BYTES
            + w["tiles"] * 8)


def k2_work(w: dict, pixels: int):
    """(bytes, ops, sfu) of K2 on one frame: its inputs, the image
    written, the alphas inside the boxes and the kept pairs' blending."""
    nbytes = _pairs_in(w) + pixels * 12
    ops = w["box"] * ALPHA_OPS + w["kept"] * K2_KEPT_OPS
    sfu = w["box"] * ALPHA_SFU + w["kept"] * K2_KEPT_SFU
    return nbytes, ops, sfu


def projection_work(w: dict, backward: bool = False):
    """(bytes, ops, sfu) of projecting every gaussian (and, with
    ``backward``, its gradient: the projected gradient in, the leaves'
    gradient out)."""
    n = w["n"]
    nbytes = n * (GAUSS_BYTES + PROJ_BYTES)
    ops, sfu = n * PROJ_OPS, n * PROJ_SFU
    if backward:
        nbytes += n * (GAUSS_BYTES + PROJ_BYTES + GAUSS_BYTES)
        ops, sfu = 3 * ops, 3 * sfu
    return nbytes, ops, sfu


def binning_work(w: dict):
    """The pairs' sort records written and read once."""
    return 2 * w["pairs"] * PAIR_KEY_BYTES, 0, 0


def frame_work(w: dict, pixels: int):
    """The whole inference frame: projection, binning, compositing."""
    return _add(projection_work(w), binning_work(w), k2_work(w, pixels))


def k3_work(w: dict, pixels: int):
    """The training forward: pairs in, raw colour and logT out."""
    nbytes = _pairs_in(w) + pixels * 16
    ops = w["box"] * ALPHA_OPS + w["kept"] * K3_KEPT_OPS
    sfu = w["box"] * ALPHA_SFU + w["kept"] * K3_KEPT_SFU
    return nbytes, ops, sfu


def k4_work(w: dict, pixels: int):
    """The training backward over the same walk: pairs and the pixel
    gradients in, nine gradient sums a visible gaussian out."""
    nbytes = _pairs_in(w) + pixels * 20 + w["visible"] * 9 * 4
    ops = w["box"] * ALPHA_OPS + w["kept"] * K4_KEPT_OPS
    sfu = w["box"] * ALPHA_SFU + w["kept"] * K4_KEPT_SFU
    return nbytes, ops, sfu


def step_work(views: list, pixels: int, params: int):
    """One training step over ``views`` (work dicts): for each view the
    projection and its backward, binning, K3, K4 and the loss; then Adam
    over ``params`` parameters."""
    parts = []
    for w in views:
        parts += [projection_work(w, backward=True), binning_work(w),
                  k3_work(w, pixels), k4_work(w, pixels),
                  (pixels * 12 * 3, pixels * SSIM_OPS_PX * 3, 0)]
    parts.append((params * ADAM_BYTES, params * 12, params))
    return _add(*parts)

"""Tile binning: (gaussian, tile) pair expansion and per-tile ordering.

Port of ``splat_tpu/render/binning.py``, keeping what it computes and
dropping the TPU workarounds:

1. each visible gaussian covers the tile rectangle of its CEIL-quantized
   1/8-px bbox (:func:`quantize_radius_bits` is, as on the TPU, the single
   source of truth for both the tile spans and the raster kernel's bbox
   test, so both packages produce the same pair sets);
   what the binning reads of each gaussian is a :class:`GaussianFront`
   (:func:`front_from_proj`), which the frame takes from the projection
   front end's kernel (``render/front.py``) and :func:`build_tile_bins`
   from a projection;
2. per-gaussian pair counts -> exclusive prefix sum (``torch.cumsum``);
3. the K1 kernel (``render/expand.py``) fills k_cap slots with int64 keys
   ``(tile << 32) | f32 depth bits`` and the owning gaussian's index;
4. ONE stable ``torch.sort`` of the keys.  Slots are laid out in scene
   order, so depth ties break by gaussian index: the exact order the oracle
   and the dense renderer use.  ``binning_key`` "depth" and "rank" both
   give this exact order (no 24-bit depth quantization, no argsort);
5. per-tile [start, end) ranges by ``torch.searchsorted``;
6. one feature gather into f32 rows (cx, cy, the prescaled conic terms,
   r, g, b, opacity, rx^2, ry^2) — no int32 bit packing, no u16 colors.

With ``cull_pairs`` K1 also drops the pairs whose alpha is below
alpha_min at every pixel of their tile (:func:`cull_rows` holds the
per-gaussian bound): they take the unfilled slots' key and are never
walked.  Capacity and overflow count them; ``num_pairs`` does not.

Capacity: K_cap = int(max_dup_factor * N) slots.  Pairs past it are
counted in ``overflow`` (the highest-index gaussians' pairs are the ones
dropped) and ``num_pairs + overflow`` is the true pair count: never a
silent truncation.  Unlike the TPU depth mode, invisible gaussians take no
slots, so the slot demand is the pair count alone.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from splat_tpu_torch.config import RenderConfig
from splat_tpu_torch.ops.projection import ProjectedGaussians
from splat_tpu_torch.render.expand import expand_pair_keys

# Rows of TileBins.features, in order (the raster kernel's layout).
FEATURE_ROWS = ("cx", "cy", "a2", "b2", "c2", "r", "g", "b", "opacity",
                "rx2", "ry2")
FEATURE_DIM = len(FEATURE_ROWS)

# 15-bit 1/8-px radius fields saturate here; a saturated field means
# "covers everything along this axis" (decodes to +inf).
_R15_MAX = 32767


@dataclasses.dataclass(frozen=True)
class TileBins:
    """Sorted (gaussian, tile) pairs ready for the raster kernel.

    features: (FEATURE_DIM, K_cap) float32, feature-major, columns ordered
      by (tile, depth, gaussian index); rows as in FEATURE_ROWS, where
      (a2, b2, c2) = (-a/2, -b, -c/2) of the conic so the kernel evaluates
      power = a2*dx^2 + c2*dy^2 + b2*dx*dy, and rx2/ry2 are the squared
      quantized radii (+inf when saturated).
    tile_start / tile_end: (T,) int32 pair ranges per tile.
    ranks: (K_cap,) int64 gaussian index of each sorted pair.
    num_pairs: () int64 valid pairs within capacity (with cull_pairs,
      those the cull kept: the pairs the raster kernel walks).
    overflow: () int64 pairs dropped for capacity.
    num_gaussians: N of the projection the pairs were binned from.
    """

    features: torch.Tensor
    tile_start: torch.Tensor
    tile_end: torch.Tensor
    ranks: torch.Tensor
    num_pairs: torch.Tensor
    overflow: torch.Tensor
    tiles_x: int
    tiles_y: int
    num_gaussians: int


def quantize_radius_bits(rx, ry, visible):
    """Pack bbox half-extents + visibility into one int32 per gaussian.

    Radii are ceil-quantized to 1/8 px in 15-bit fields (saturating at the
    _R15_MAX sentinel); bit 30 carries visibility.  The float clip happens
    before the int cast, and NaN radii (invisible gaussians only) become 0.
    """
    def q15(r):
        v = torch.clamp(torch.ceil(r * 8.0), 0.0, float(_R15_MAX))
        return torch.where(torch.isnan(v), torch.zeros_like(v), v).to(
            torch.int32)

    return q15(rx) | (q15(ry) << 15) | (visible.to(torch.int32) << 30)


def decode_radius_bits(bits):
    """Inverse of quantize_radius_bits: (rx, ry, visible); a saturated
    field decodes to +inf."""
    rxq = bits & 0x7FFF
    ryq = (bits >> 15) & 0x7FFF
    rx = torch.where(rxq == _R15_MAX, math.inf,
                     rxq.to(torch.float32) * 0.125)
    ry = torch.where(ryq == _R15_MAX, math.inf,
                     ryq.to(torch.float32) * 0.125)
    vis = ((bits >> 30) & 1).to(torch.bool)
    return rx, ry, vis


def tile_spans(cx, cy, rbits, tpx: int, tpy: int, ntx: int, nty: int):
    """Tile-rect spans + pair counts from quantized radius bits:
    (tx0, ty0, span_w, counts), all (N,) int32.

    Invisible gaussians may carry NaN centers, so every field is gated on
    the visibility bit in float, before the int cast.
    """
    rx, ry, vis = decode_radius_bits(rbits)

    def edge(v, tp, nt):
        f = torch.clamp(torch.floor(v / tp), 0, nt - 1)
        return torch.where(vis, f, torch.zeros_like(f)).to(torch.int32)

    tx0, tx1 = edge(cx - rx, tpx, ntx), edge(cx + rx, tpx, ntx)
    ty0, ty1 = edge(cy - ry, tpy, nty), edge(cy + ry, tpy, nty)
    sw = tx1 - tx0 + 1
    counts = torch.where(vis, sw * (ty1 - ty0 + 1), torch.zeros_like(sw))
    return tx0, ty0, sw, counts


def _grid(h: int, w: int, config: RenderConfig):
    ntx = -(-w // config.tile_w)
    nty = -(-h // config.tile_h)
    return ntx, nty


def _spans(proj: ProjectedGaussians, h: int, w: int, config: RenderConfig):
    ntx, nty = _grid(h, w, config)
    rbits = quantize_radius_bits(proj.radius_px[:, 0], proj.radius_px[:, 1],
                                 proj.visible)
    spans = tile_spans(proj.center_px[:, 0], proj.center_px[:, 1], rbits,
                       config.tile_w, config.tile_h, ntx, nty)
    return rbits, spans


# cull_rows' margins: the bound on the least eigenvalue gives way by this
# share of the trace, the log threshold by CULL_LOG_MARGIN (see cull_rows)
CULL_TRACE_MARGIN = 1e-5
CULL_LOG_MARGIN = 1e-4
# centres farther than this from the origin, in pixels, are never culled
CULL_MAX_CENTRE = 1e6


def cull_rows(proj: ProjectedGaussians, alpha_min: float) -> torch.Tensor:
    """(N, 4) f32 rows (cx, cy, lam, thresh) of K1's dead-pair cull.

    A pair of gaussian g and a tile whose nearest pixel lies (dx, dy) from
    the centre is dead where ``(dx*dx + dy*dy) * lam > thresh`` in f32.
    lam is the conic's least eigenvalue, det / lam_max (no cancellation in
    the root; f32 error a few ulp of the trace), less CULL_TRACE_MARGIN of
    the trace; thresh is 2 log(opacity / alpha_min) + CULL_LOG_MARGIN.  So
    at every pixel of the tile the raster kernel's own f32 alpha,
    min(clamp, op * exp(power)), is below alpha_min: its power's rounding
    is at most a few ulp of trace * d^2, far inside the first margin, and
    its exp and product within the second.  The culled pair would
    composite nothing; the cull is lossless.

    thresh = +inf never culls (``splat_tpu``'s ``r8 == 255``): invisible
    splats, non-finite fields or opacity <= 0 (lam or thresh not finite),
    centres beyond CULL_MAX_CENTRE px or NaN, and splats so thin that the
    margin leaves lam <= 0.  The other fields of such a row are left as
    they come: nothing exceeds +inf."""
    a, b, c = proj.conic.unbind(1)
    tr = a + c
    lam = ((a * c - b * b) / (0.5 * tr + torch.hypot(0.5 * (a - c), b))
           - CULL_TRACE_MARGIN * tr)
    thresh = 2.0 * torch.log(proj.opacity / alpha_min) + CULL_LOG_MARGIN
    cx, cy = proj.center_px.unbind(1)
    ok = (proj.visible & torch.isfinite(lam) & torch.isfinite(thresh)
          & (lam > 0) & (cx.abs() <= CULL_MAX_CENTRE)
          & (cy.abs() <= CULL_MAX_CENTRE))
    return torch.stack([cx, cy, lam, torch.where(ok, thresh, math.inf)],
                       dim=1)


def count_pairs(proj: ProjectedGaussians, h: int, w: int,
                config: RenderConfig):
    """Exact pair count the binning stage will produce.
    Returns (visible, num_pairs) as () int64 device tensors."""
    _, (_, _, _, counts) = _spans(proj, h, w, config)
    return proj.visible.sum(), counts.sum(dtype=torch.int64)


@dataclasses.dataclass(frozen=True)
class SlotLayout:
    """Everything the pair-expansion kernel reads, for one frame.

    first_slot: (N,) int64 exclusive prefix sum of the pair counts.
    tx0 / ty0 / span_w: (N,) int32 tile rectangles.
    depth_bits: (N,) int32 bits of the f32 view depths.
    total: (1,) int64 true pair count.
    rbits: (N,) int32 quantized radii + visibility (quantize_radius_bits).
    tile_wh: the config's (tile_w, tile_h), which the cull tests against.
    cull: (N, 4) f32 :func:`cull_rows`, or None (config.cull_pairs off).
    """

    first_slot: torch.Tensor
    tx0: torch.Tensor
    ty0: torch.Tensor
    span_w: torch.Tensor
    depth_bits: torch.Tensor
    total: torch.Tensor
    rbits: torch.Tensor
    k_cap: int
    tiles_x: int
    tiles_y: int
    tile_wh: tuple[int, int]
    cull: torch.Tensor | None = None

    def expand(self, fn=None):
        """Run the expansion (``expand_pair_keys`` unless ``fn`` is given,
        e.g. its plain version): ((k_cap,) keys, (k_cap,) owners)."""
        return (fn or expand_pair_keys)(
            self.first_slot, self.tx0, self.ty0, self.span_w,
            self.depth_bits, self.total, k_cap=self.k_cap,
            ntx=self.tiles_x, num_tiles=self.tiles_x * self.tiles_y,
            cull=self.cull, tile_wh=self.tile_wh)


@dataclasses.dataclass(frozen=True)
class GaussianFront:
    """What the binning reads of each gaussian, for one frame: the output
    of the projection front end (``render/front.py``).

    rbits: (N,) int32 quantized radii + visibility (quantize_radius_bits).
    tx0 / ty0 / span_w / counts: (N,) int32 tile rectangles and pair
      counts (tile_spans).
    depth_bits: (N,) int32 bits of the f32 view depths.
    features: (FEATURE_DIM, N) float32 rows of FEATURE_ROWS, gaussian
      order (TileBins.features before the sort's gather).
    cull: (N, 4) f32 :func:`cull_rows`, or None (config.cull_pairs off).
    num_visible: () int64 visible gaussians.
    """

    rbits: torch.Tensor
    tx0: torch.Tensor
    ty0: torch.Tensor
    span_w: torch.Tensor
    counts: torch.Tensor
    depth_bits: torch.Tensor
    features: torch.Tensor
    cull: torch.Tensor | None
    num_visible: torch.Tensor


def front_from_proj(proj: ProjectedGaussians, h: int, w: int,
                    config: RenderConfig) -> GaussianFront:
    """The per-gaussian binning inputs of one frame's projection."""
    rbits, (tx0, ty0, sw, counts) = _spans(proj, h, w, config)
    rx, ry, _ = decode_radius_bits(rbits)
    color = torch.clamp(proj.color, 0.0, 1.0)
    feats_n = torch.stack([
        proj.center_px[:, 0], proj.center_px[:, 1],
        -0.5 * proj.conic[:, 0], -proj.conic[:, 1], -0.5 * proj.conic[:, 2],
        color[:, 0], color[:, 1], color[:, 2], proj.opacity,
        rx * rx, ry * ry,
    ])                                                      # (F, N)
    return GaussianFront(rbits=rbits, tx0=tx0, ty0=ty0, span_w=sw,
                         counts=counts,
                         depth_bits=proj.depth.contiguous().view(torch.int32),
                         features=feats_n,
                         cull=(cull_rows(proj, config.alpha_min)
                               if config.cull_pairs else None),
                         num_visible=proj.visible.sum())


def front_layout(front: GaussianFront, h: int, w: int,
                 config: RenderConfig) -> SlotLayout:
    """The pair counts' prefix sum and the tile spans for one frame."""
    ntx, nty = _grid(h, w, config)
    counts = front.counts
    n = counts.shape[0]
    cum = torch.cumsum(counts, 0, dtype=torch.int64)
    total = (cum[-1:] if n else torch.zeros(1, dtype=torch.int64,
                                            device=cum.device))
    return SlotLayout(first_slot=cum - counts, tx0=front.tx0, ty0=front.ty0,
                      span_w=front.span_w, depth_bits=front.depth_bits,
                      total=total.contiguous(), rbits=front.rbits,
                      k_cap=int(config.max_dup_factor * n),
                      tiles_x=ntx, tiles_y=nty, cull=front.cull,
                      tile_wh=(config.tile_w, config.tile_h))


def slot_layout(proj: ProjectedGaussians, h: int, w: int,
                config: RenderConfig) -> SlotLayout:
    """Tile spans, pair counts and their prefix sum for one frame."""
    return front_layout(front_from_proj(proj, h, w, config), h, w, config)


def tile_edges(sorted_keys, num_tiles: int):
    """(T + 1,) int32 boundaries of each tile's run in the sorted keys."""
    queries = torch.arange(num_tiles + 1, dtype=torch.int64,
                           device=sorted_keys.device) << 32
    return torch.searchsorted(sorted_keys, queries).to(torch.int32)


def bin_front(front: GaussianFront, h: int, w: int,
              config: RenderConfig) -> TileBins:
    """Bin one frame's per-gaussian inputs into sorted per-tile pairs."""
    lay = front_layout(front, h, w, config)
    keys, owners = lay.expand()
    sorted_keys, perm = torch.sort(keys, stable=True)
    ranks = owners[perm]
    edges = tile_edges(sorted_keys, lay.tiles_x * lay.tiles_y)
    total = lay.total[0]
    # with the cull, the pairs it kept: those below the unfilled slots' key
    kept = (edges[-1].to(torch.int64) if lay.cull is not None
            else torch.clamp(total, max=lay.k_cap))
    return TileBins(features=front.features.index_select(1, ranks),
                    tile_start=edges[:-1].contiguous(),
                    tile_end=edges[1:].contiguous(), ranks=ranks,
                    num_pairs=kept,
                    overflow=torch.clamp(total - lay.k_cap, min=0),
                    tiles_x=lay.tiles_x, tiles_y=lay.tiles_y,
                    num_gaussians=front.counts.shape[0])


def build_tile_bins(proj: ProjectedGaussians, h: int, w: int,
                    config: RenderConfig) -> TileBins:
    """Bin one frame's projected gaussians into sorted per-tile pairs."""
    return bin_front(front_from_proj(proj, h, w, config), h, w, config)

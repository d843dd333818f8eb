"""Render configuration (PyTorch port).

Same field names, defaults and validation as ``splat_tpu.config`` so one set
of keyword arguments drives both packages.  The knobs that only shape the TPU
kernels' internals are accepted and have no effect on the card; the knobs
whose TPU machinery changes which (gaussian, tile) pairs are walked raise
``NotImplementedError`` until the port carries that machinery.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static configuration for the renderer.

    Attributes (see ``splat_tpu.config.RenderConfig`` for the full history
    of each knob):
      sh_degree: spherical-harmonics degree for view-dependent color, 0..3.
      lowpass: added to the diagonal of the projected 2D covariance.
      alpha_clamp: upper clamp on per-splat alpha.
      alpha_min: pairs with alpha below this are skipped; a tile stops its
        walk once every pixel's transmittance is below it.
      train_sat_exit: training path (render_tiled_diff) only: each tile's
        walk stops once every pixel has T < alpha_min (checked every 4
        windows) instead of at the exact f32 saturation cut.
      tile_px / tile_py: tile width / height in pixels (tile_py 0 = square).
        The raster kernel takes tiles of at most 4096 pixels.
      max_dup_factor: capacity of the (gaussian, tile) pair buffer as a
        multiple of N.  Overflow is counted and reported, never silent.
      chunk: the raster kernel's shared-memory batch size: the pairs of a
        tile are staged ``chunk`` at a time, and the whole-tile saturation
        exit is checked after each batch.  Batch boundaries sit at absolute
        multiples of ``chunk`` in the sorted pair array, which for chunk 64
        or 128 are exactly the TPU kernel's window boundaries.
      cull_pairs: not ported (raises NotImplementedError when True).
      expand_impl: TPU expansion selector; no effect on the card (the port
        has one expansion kernel).
      binning_key: "depth" or "rank".  On the card both give the same exact
        front-to-back order: the pair sort key carries the full f32 depth
        and the stable sort breaks ties by gaussian index.
      background: color composited under the final transmittance.
      subtile_exit: not ported (raises NotImplementedError when True).
      subtile_heavy_pairs: only read with subtile_exit; no effect.
      transmit_mxu / exact_color_accum: TPU matrix-unit choices; no effect
        on the card, where transmittance is a serial product and colors
        accumulate in f32.
      alpha_channel: output RGBA with the accumulated coverage 1 - T.
      render_mode: "color" or "depth" (normalized expected depth).
      depth_range: (near, far) for depth mode; None = per-frame auto range.
      supersample: render at k x resolution and box-filter down.
      sigma_cutoff: bbox radius in standard deviations (inf requires
        tight_radius and drops the raster kernel's bbox test).
      tight_radius: shrink bboxes to the opacity-aware kill radius.
      cov3d_transpose / sh_stale_eye: reference-quirk reproduction flags
        (PARITY.md).
    """

    sh_degree: int = 3
    lowpass: float = 0.3
    alpha_clamp: float = 0.99
    alpha_min: float = 1.0 / 255.0
    train_sat_exit: bool = False
    tile_px: int = 32
    tile_py: int = 0
    max_dup_factor: float = 4.0
    chunk: int = 128
    cull_pairs: bool = False
    expand_impl: str = "auto"
    binning_key: str = "depth"
    background: tuple[float, float, float] = (0.0, 0.0, 0.0)
    subtile_exit: bool = False
    subtile_heavy_pairs: int = 8192
    transmit_mxu: bool = True
    exact_color_accum: bool = False
    alpha_channel: bool = False
    render_mode: str = "color"
    depth_range: tuple[float, float] | None = None
    supersample: int = 1
    sigma_cutoff: float = 3.0
    tight_radius: bool = True
    cov3d_transpose: bool = False
    sh_stale_eye: bool = False

    def __post_init__(self):
        if not (0 <= self.sh_degree <= 3):
            raise ValueError(f"sh_degree must be in [0,3], got {self.sh_degree}")
        if self.tile_px % 8 != 0:
            raise ValueError(f"tile_px must be a multiple of 8, got {self.tile_px}")
        if self.tile_py % 8 != 0:
            raise ValueError(f"tile_py must be a multiple of 8, got {self.tile_py}")
        if self.expand_impl not in ("auto", "xla"):
            raise ValueError(f"expand_impl must be 'auto' or 'xla', "
                             f"got {self.expand_impl!r}")
        if self.binning_key not in ("rank", "depth"):
            raise ValueError(f"binning_key must be 'rank' or 'depth', "
                             f"got {self.binning_key!r}")
        if not (isinstance(self.supersample, int) and self.supersample >= 1):
            raise ValueError(f"supersample must be an int >= 1, "
                             f"got {self.supersample!r}")
        if self.render_mode not in ("color", "depth"):
            raise ValueError(f"render_mode must be 'color' or 'depth', "
                             f"got {self.render_mode!r}")
        if self.depth_range is not None:
            lo, hi = self.depth_range
            if not (math.isfinite(lo) and math.isfinite(hi) and lo < hi):
                raise ValueError(f"depth_range must be finite (near, far) "
                                 f"with near < far, got {self.depth_range}")
        if not math.isfinite(self.sigma_cutoff) and not self.tight_radius:
            raise ValueError(
                "sigma_cutoff=inf requires tight_radius=True: without the "
                "opacity-aware radius every bbox covers the whole screen "
                "(pair count = N x tiles)")
        if self.chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {self.chunk}")
        if self.subtile_exit:
            raise NotImplementedError(
                "subtile_exit (per-group phase compaction) is not ported")
        if self.cull_pairs:
            raise NotImplementedError("cull_pairs is not ported")

    @property
    def tile_w(self) -> int:
        """Tile width in pixels."""
        return self.tile_px

    @property
    def tile_h(self) -> int:
        """Tile height in pixels (tile_py, defaulting to square tiles)."""
        return self.tile_py or self.tile_px

    @property
    def block_shape(self) -> tuple[int, int]:
        """The TPU kernel's (sublane, lane) view of a tile; kept for API
        parity, unused on the card."""
        n = self.tile_w * self.tile_h
        lanes = 128
        if n % lanes:
            raise ValueError(f"tile pixels {n} not a multiple of 128")
        return (n // lanes, lanes)

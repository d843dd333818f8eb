"""The compositing kernel's (K2) plain version held against splat_tpu's
Pallas raster kernel in interpret mode on the SAME pair lists: the JAX
binning's packed feature table is decoded into the port's f32 rows (CPU)."""

import math

import numpy as np
import pytest
import torch

import splat_tpu as st
from splat_tpu.ops.projection import project_gaussians as jax_project
from splat_tpu.render.binning import _R15_MAX
from splat_tpu.render.binning import build_tile_bins as jax_bins
from splat_tpu.render.kernels import rasterize_tiles as jax_raster
from splat_tpu_torch import RenderConfig
from splat_tpu_torch.render.binning import FEATURE_ROWS, TileBins
from splat_tpu_torch.render.kernels import rasterize_tiles_plain
from splat_tpu_torch.utils.image import psnr

torch.set_num_threads(1)

H, W = 80, 112          # not multiples of the 32-px tile: edge tiles


def _port_bins(jb) -> TileBins:
    """The port's f32 feature rows decoded from the JAX packed table
    exactly as the Pallas kernel decodes them (splat_tpu kernels.py)."""
    f = np.asarray(jb.features)
    frow = lambda i: f[i].view(np.float32)
    inv = np.float32(1.0 / 65535.0)
    lo = lambda i: (f[i] & 0xFFFF).astype(np.float32) * inv
    hi = lambda i: ((f[i] >> 16) & 0xFFFF).astype(np.float32) * inv
    rxq, ryq = f[7] & 0x7FFF, (f[7] >> 15) & 0x7FFF
    rx = rxq.astype(np.float32) * np.float32(0.125)
    ry = ryq.astype(np.float32) * np.float32(0.125)
    rows = [frow(0), frow(1), frow(2), frow(3), frow(4), lo(5), hi(5), lo(6),
            hi(6), np.where(rxq == _R15_MAX, np.inf, rx * rx),
            np.where(ryq == _R15_MAX, np.inf, ry * ry)]
    feats = torch.from_numpy(np.stack(rows).astype(np.float32))
    return TileBins(features=feats,
                    tile_start=torch.tensor(np.asarray(jb.tile_start)),
                    tile_end=torch.tensor(np.asarray(jb.tile_end)),
                    ranks=torch.tensor(np.asarray(jb.ranks)).long(),
                    num_pairs=torch.tensor(int(jb.num_pairs)),
                    overflow=torch.tensor(int(jb.overflow)),
                    tiles_x=jb.tiles_x, tiles_y=jb.tiles_y,
                    num_gaussians=int(np.asarray(jb.ranks).max()) + 1)


@pytest.mark.parametrize("cfg_kw", [
    dict(chunk=64),
    dict(chunk=64, alpha_channel=True, background=(0.2, 0.4, 0.9),
         sigma_cutoff=math.inf),
], ids=["default", "rgba_bg_sigma_inf"])
def test_raster_plain_matches_pallas_kernel(cfg_kw):
    scene = st.random_scene(1200, seed=21, extent=1.5,
                            scale_range=(0.02, 0.15))
    cam = st.Camera.create(h=H, w=W, position=(0.0, 0.0, 3.5), yaw=0.2)
    jcfg = st.RenderConfig(**cfg_kw)
    jb = jax_bins(jax_project(scene, cam, jcfg), H, W, jcfg)
    assert int(jb.num_pairs) > 0
    want = np.asarray(jax_raster(jb, H, W, jcfg, interpret=True))
    got = rasterize_tiles_plain(_port_bins(jb), H, W, RenderConfig(**cfg_kw))
    assert got.shape == want.shape == (H, W, 4 if "alpha_channel" in cfg_kw
                                       else 3)
    # same pairs, same whole-tile exit points: only the TPU kernel's
    # log-space prefix product differs from the serial product
    assert psnr(got.numpy(), want) >= 60.0


@pytest.mark.parametrize("chunk,want", [(2, 0.0), (4, 0.0035 * 0.99)])
def test_whole_tile_exit_is_batch_granular(chunk, want):
    # three flat splats (zero conic: alpha = opacity at every pixel) over
    # one 32x32 tile of a 20x24 image.  After the first two, T = 0.01 *
    # 0.35 < alpha_min at every pixel, so the third (white) is composited
    # only when it shares their batch.
    n = 3
    feats = torch.zeros((len(FEATURE_ROWS), n))
    feats[0:2] = 10.0
    feats[5:8, 2] = 1.0
    feats[8] = torch.tensor([0.99, 0.65, 0.99])
    feats[9:11] = math.inf
    bins = TileBins(features=feats,
                    tile_start=torch.tensor([0], dtype=torch.int32),
                    tile_end=torch.tensor([n], dtype=torch.int32),
                    ranks=torch.arange(n), num_pairs=torch.tensor(n),
                    overflow=torch.tensor(0), tiles_x=1, tiles_y=1,
                    num_gaussians=n)
    img = rasterize_tiles_plain(bins, 20, 24, RenderConfig(chunk=chunk))
    assert img.shape == (20, 24, 3)
    np.testing.assert_allclose(img.numpy(), want, atol=1e-6)

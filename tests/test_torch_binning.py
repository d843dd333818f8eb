"""The PyTorch port's tile binning and pair-expansion (K1) plain version,
held against splat_tpu's binning (Pallas expansion in interpret mode, as
tests/test_tiled.py runs it) and against a hand-written expansion (CPU)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import splat_tpu as st
import splat_tpu_torch as stt
from splat_tpu.ops.projection import project_gaussians as jax_project
from splat_tpu.render.binning import build_tile_bins as jax_bins
from splat_tpu.render.binning import count_pairs as jax_count_pairs
from splat_tpu_torch.device import resolve_device
from splat_tpu_torch.ops.projection import project_gaussians
from splat_tpu_torch.render import binning
from splat_tpu_torch.render.expand import (expand_pair_keys,
                                           expand_pair_keys_plain)
from splat_tpu_torch.render.diff import (rasterize_train_bwd,
                                         rasterize_train_fwd)
from splat_tpu_torch.render.kernels import rasterize_tiles

torch.set_num_threads(1)

H, W = 96, 128


@pytest.fixture(scope="module")
def frame():
    js = st.random_scene(2000, seed=11, extent=2.0, scale_range=(0.01, 0.1))
    ts = stt.GaussianScene.from_numpy(js.to_numpy(), device="cpu")
    kw = dict(h=H, w=W, position=(0.0, 0.0, 4.0), yaw=0.3, pitch=-0.2)
    jc, tc = st.Camera.create(**kw), stt.Camera.create(**kw, device="cpu")
    jcfg, tcfg = st.RenderConfig(chunk=64), stt.RenderConfig(chunk=64)
    jp = jax_project(js, jc, jcfg)
    tp = project_gaussians(ts, tc, tcfg)
    return jp, tp, jcfg, tcfg


def test_tile_bins_match_jax(frame):
    jp, tp, jcfg, tcfg = frame
    jb = jax_bins(jp, H, W, jcfg)
    tb = binning.build_tile_bins(tp, H, W, tcfg)
    assert (tb.tiles_x, tb.tiles_y) == (jb.tiles_x, jb.tiles_y)
    js_, je = np.asarray(jb.tile_start), np.asarray(jb.tile_end)
    ts_, te = tb.tile_start.numpy(), tb.tile_end.numpy()
    # same pair multiset in every tile -> identical ranges
    np.testing.assert_array_equal(ts_, js_)
    np.testing.assert_array_equal(te, je)
    jr, tr = np.asarray(jb.ranks), tb.ranks.numpy()
    depth = tp.depth.numpy()
    for t in range(len(ts_)):
        ids = tr[ts_[t]:te[t]]
        assert sorted(ids) == sorted(jr[js_[t]:je[t]]), t
        # exact front-to-back order, ties broken by gaussian index
        key = list(zip(depth[ids], ids))
        assert key == sorted(key), t
    _, pairs = jax_count_pairs(jp, H, W, jcfg)
    assert int(tb.num_pairs) == int(pairs) == int(jb.num_pairs) > 0
    assert int(tb.overflow) == 0 == int(jb.overflow)
    vis, tpairs = binning.count_pairs(tp, H, W, tcfg)
    assert int(tpairs) == int(pairs)
    assert int(vis) == int(np.asarray(jp.visible).sum())
    # feature rows carry each pair's own gaussian
    cx = tb.features[binning.FEATURE_ROWS.index("cx"), :int(tb.num_pairs)]
    np.testing.assert_array_equal(
        cx.numpy(), tp.center_px[:, 0].numpy()[tb.ranks[:len(cx)].numpy()])


def test_overflow_is_counted_never_silent(frame):
    _, tp, _, tcfg = frame
    _, pairs = binning.count_pairs(tp, H, W, tcfg)
    small = stt.RenderConfig(chunk=64, max_dup_factor=0.25)
    tb = binning.build_tile_bins(tp, H, W, small)
    k_cap = int(0.25 * tp.depth.shape[0])
    assert int(pairs) > k_cap
    assert int(tb.num_pairs) == k_cap
    assert int(tb.num_pairs) + int(tb.overflow) == int(pairs)
    assert int((tb.tile_end - tb.tile_start).sum()) == k_cap


def _expand_by_hand(first, tx0, ty0, sw, dbits, total, k_cap, ntx, nt):
    keys = [nt << 32] * k_cap
    owners = [0] * k_cap
    counts = np.diff(np.append(first, total))
    for g, c in enumerate(counts):
        for r in range(c):
            k = first[g] + r
            if k < k_cap:
                tile = (ty0[g] + r // sw[g]) * ntx + tx0[g] + r % sw[g]
                keys[k] = (int(tile) << 32) | (int(dbits[g]) & 0xFFFFFFFF)
                owners[k] = g
    return keys, owners


@pytest.mark.parametrize("k_cap", [40, 23, 0], ids=["room", "overflow",
                                                    "empty"])
def test_expand_plain_matches_hand_expansion(k_cap):
    # gaussians 1, 3, 4 and 7 cover no tile (zero counts, no fake slots)
    tx0 = np.array([0, 0, 2, 0, 0, 5, 1, 0, 3], np.int32)
    ty0 = np.array([0, 0, 1, 0, 0, 0, 2, 0, 3], np.int32)
    sw = np.array([2, 1, 3, 1, 1, 1, 2, 1, 4], np.int32)
    hgt = np.array([1, 0, 2, 0, 0, 3, 2, 0, 2], np.int32)
    counts = np.where(hgt > 0, sw * hgt, 0)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    total = int(counts.sum())
    dbits = np.float32(np.linspace(0.5, 4.0, 9)).view(np.int32)
    ntx, nt = 8, 40
    keys, owners = expand_pair_keys_plain(
        torch.from_numpy(first), torch.from_numpy(tx0),
        torch.from_numpy(ty0), torch.from_numpy(sw), torch.from_numpy(dbits),
        torch.tensor([total]), k_cap=k_cap, ntx=ntx, num_tiles=nt)
    want_k, want_o = _expand_by_hand(first, tx0, ty0, sw, dbits, total,
                                     k_cap, ntx, nt)
    assert keys.dtype == owners.dtype == torch.int64
    assert keys.tolist() == want_k
    assert owners.tolist() == want_o


def test_cpu_tensors_take_plain_versions(frame):
    _, tp, _, tcfg = frame
    kernels = (expand_pair_keys, rasterize_tiles, rasterize_train_fwd,
               rasterize_train_bwd)
    for fn in kernels:
        fn.launches = 0
    tb = binning.build_tile_bins(tp, H, W, tcfg)
    rasterize_tiles(tb, H, W, tcfg)
    c, lt, cut = rasterize_train_fwd(tb, H, W, tcfg)
    rasterize_train_bwd(tb, torch.ones_like(c), torch.ones_like(lt), lt, cut,
                        H, W, tcfg)
    assert [fn.launches for fn in kernels] == [0, 0, 0, 0]
    # any other device raises instead of falling back
    lay = binning.slot_layout(tp, H, W, tcfg)
    meta = [t.to("meta") for t in (lay.first_slot, lay.tx0, lay.ty0,
                                   lay.span_w, lay.depth_bits, lay.total)]
    with pytest.raises(ValueError):
        expand_pair_keys(*meta, k_cap=lay.k_cap, ntx=lay.tiles_x,
                         num_tiles=lay.tiles_x * lay.tiles_y)
    meta_bins = dataclasses.replace(tb, features=tb.features.to("meta"))
    for fn in (rasterize_tiles, rasterize_train_fwd):
        with pytest.raises(ValueError):
            fn(meta_bins, H, W, tcfg)


_DEFAULT_DEVICE_MAKERS = {
    "camera": lambda: stt.Camera.create(h=8, w=8),
    "scene": lambda: stt.GaussianScene.create(
        np.zeros((1, 3)), np.ones((1, 4)), np.ones((1, 3)), np.ones(1),
        np.zeros((1, 16, 3))),
    "random_scene": lambda: stt.random_scene(4),
    "naive_gaussians": lambda: stt.naive_gaussians(),
    "load_ply": lambda: stt.load_ply(os.path.join(
        os.path.dirname(__file__), "data", "surface_5k.ply")),
}


@pytest.mark.parametrize("make", list(_DEFAULT_DEVICE_MAKERS))
def test_default_device_is_the_card_never_the_cpu(monkeypatch, make):
    """No device= means cuda:0; without a card that raises instead of
    quietly building CPU tensors (which would take the plain versions)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _DEFAULT_DEVICE_MAKERS[make]()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")


def test_radius_bits_saturate_and_survive_nan():
    rx = torch.tensor([0.01, 2.5, 5000.0, float("inf"), float("nan")])
    ry = torch.tensor([1.0, 0.0, 1.0, 1.0, float("nan")])
    vis = torch.tensor([True, True, True, True, False])
    bits = binning.quantize_radius_bits(rx, ry, vis)
    drx, _, dvis = binning.decode_radius_bits(bits)
    assert drx.tolist()[:3] == [0.125, 2.5, float("inf")]
    assert drx[3] == float("inf") and drx[4] == 0.0
    assert dvis.tolist() == vis.tolist()
    tx0, ty0, sw, counts = binning.tile_spans(
        torch.tensor([10.0, 40.0, 50.0, 60.0, float("nan")]),
        torch.tensor([10.0] * 4 + [float("nan")]), bits, 32, 32, 4, 3)
    assert sw.tolist()[2:4] == [4, 4] and counts[4] == 0

"""The PyTorch port's training module held against splat_tpu.train on the
same numpy-seeded scenes, views and targets (CPU): raw parameters and
their npz checkpoints, SSIM/PSNR, the photometric loss and its gradients
(dense and tiled), densification, and the fit loop itself.  Each JAX
result is computed once."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import splat_tpu as st
from splat_tpu import train as jt
from splat_tpu.camera import orbit_trajectory as jax_orbit
import splat_tpu_torch as stt
from splat_tpu_torch import train as tt

torch.set_num_threads(1)

RAW = ("means", "quats", "log_scales", "logit_opacities", "sh")
H, W = 32, 48
CAM = dict(h=H, w=W, position=(0.0, 0.0, 4.0))


def _truth():
    return st.random_scene(300, seed=3, extent=1.5, scale_range=(0.03, 0.15))


def _start(d):
    """The truth perturbed: dimmer colours, jittered centres."""
    rng = np.random.default_rng(7)
    d = dict(d)
    d["sh"] = d["sh"] * np.float32(0.6)
    d["means"] = d["means"] + rng.normal(0, 0.03, d["means"].shape).astype(
        np.float32)
    return d


def _cams():
    jc = jax_orbit(st.Camera.create(**CAM), num_frames=2, yaw_sweep=0.6)
    tc = stt.orbit_trajectory(stt.Camera.create(**CAM, device="cpu"),
                              num_frames=2, yaw_sweep=0.6)
    return jc, tc


def _cos(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / np.sqrt((a @ a) * (b @ b) + 1e-300))


@pytest.fixture(scope="module")
def problem():
    """Targets rendered densely from the truth by JAX, and the start."""
    d = _truth().to_numpy()
    jc, tc = _cams()
    cfg_kw = dict(max_dup_factor=8.0, sh_degree=1)
    truth = jax.tree.map(jnp.asarray, st.GaussianScene(**d))
    targets = np.asarray(jax.vmap(lambda c: st.render_dense(
        truth, c, st.RenderConfig(**cfg_kw)))(jc))
    return {"start": _start(d), "targets": targets, "jc": jc, "tc": tc,
            "cfg_kw": cfg_kw}


def _raws(d):
    jraw = jt.RawParams.from_scene(jax.tree.map(jnp.asarray,
                                                st.GaussianScene(**d)))
    traw = tt.RawParams.from_scene(stt.GaussianScene.from_numpy(
        d, device="cpu"))
    return jraw, traw


def test_orbit_trajectory_matches_jax():
    jc, tc = _cams()
    assert len(tc) == 2 and tc[0].h == H and tc[1].w == W
    for i, cam in enumerate(tc):
        np.testing.assert_allclose(float(cam.yaw), float(jc.yaw[i]),
                                   rtol=1e-6)
        jcam = jax.tree.map(lambda a: a[i], jc)
        np.testing.assert_allclose(cam.view_matrix().numpy(),
                                   np.asarray(jcam.view_matrix()),
                                   rtol=1e-5, atol=1e-6)


def test_raw_params_match_jax_and_round_trip():
    d = _truth().to_numpy()
    jraw, traw = _raws(d)
    for k in RAW:
        np.testing.assert_allclose(getattr(traw, k).numpy(),
                                   np.asarray(getattr(jraw, k)),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    back = tt.RawParams.from_numpy(traw.to_numpy(), device="cpu").to_scene()
    ref = jraw.to_scene()
    for k in ("means", "quats", "scales", "opacities", "sh"):
        np.testing.assert_allclose(getattr(back, k).numpy(),
                                   np.asarray(getattr(ref, k)), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_raw_params_npz_interop_is_bit_exact(tmp_path, writer):
    d = _truth().to_numpy()
    jraw, traw = _raws(d)
    path = str(tmp_path / "raw.npz")
    if writer == "jax":
        jt.save_raw_params(path, jraw)
        got = tt.load_raw_params(path, device="cpu")
        want = {k: np.asarray(getattr(jraw, k)) for k in RAW}
        got = got.to_numpy()
    else:
        tt.save_raw_params(path, traw)
        got = {k: np.asarray(getattr(jt.load_raw_params(path), k))
               for k in RAW}
        want = traw.to_numpy()
    for k in RAW:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("pair", ["random", "near", "same"])
def test_ssim_and_psnr_match_jax(pair):
    rng = np.random.default_rng(4)
    a = rng.uniform(0, 1, (40, 56, 3)).astype(np.float32)
    b = {"random": rng.uniform(0, 1, a.shape),
         "near": a + rng.normal(0, 0.05, a.shape),
         "same": a}[pair].astype(np.float32)
    ta = torch.tensor(a, requires_grad=True)
    got = tt.ssim(ta, torch.tensor(b))
    got.backward()
    want, g = jax.value_and_grad(jt.ssim)(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    if pair != "same":      # (at a == b the gradient is zero up to noise)
        # the blur's hand-written backward (the same blur)
        g = np.asarray(g)
        assert np.abs(ta.grad.numpy() - g).max() <= 1e-4 * np.abs(g).max()
        np.testing.assert_allclose(
            float(tt.psnr(torch.tensor(a), torch.tensor(b))),
            float(jt.psnr(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5)


@pytest.mark.parametrize("method", ["dense", "tiled"])
def test_photometric_loss_and_gradients_match_jax(problem, method):
    d = problem["start"]
    jraw, traw = _raws(d)
    cfg_kw = problem["cfg_kw"]

    def jloss(r):
        return jt.photometric_loss(r, problem["jc"], problem["targets"],
                                   st.RenderConfig(**cfg_kw),
                                   dssim_weight=0.2, method=method)

    jl, jg = jax.value_and_grad(jloss)(jraw)
    leaves = {k: getattr(traw, k).clone().requires_grad_(True) for k in RAW}
    tl = tt.photometric_loss(tt.RawParams(**leaves), problem["tc"],
                             torch.tensor(problem["targets"]),
                             stt.RenderConfig(**cfg_kw), dssim_weight=0.2,
                             method=method)
    tl.backward()
    # f32 sums in another order; tiled: JAX also quantizes colour and
    # opacity to u16 (~1.5e-5)
    np.testing.assert_allclose(float(tl.detach()), float(jl),
                               rtol=1e-4)
    for k in RAW:
        assert _cos(leaves[k].grad.numpy(),
                    np.asarray(getattr(jg, k))) >= 0.999, k


@pytest.mark.parametrize("kw", [
    dict(grad_threshold=2e-4),
    dict(grad_threshold=1e-4, split_scale_threshold=0.05,
         max_gaussians=320, min_opacity=0.3, pad_multiple=64, seed=3),
], ids=["default", "capped"])
def test_densify_and_prune_matches_jax(kw):
    d = _truth().to_numpy()
    op = d["opacities"]
    raw = {"means": d["means"], "quats": d["quats"],
           "log_scales": np.log(d["scales"]),
           "logit_opacities": np.log(op) - np.log1p(-op), "sh": d["sh"]}
    # the same raw leaves on both sides
    traw = tt.RawParams.from_numpy(raw, device="cpu")
    jraw = jt.RawParams(**{k: jnp.asarray(v)
                           for k, v in traw.to_numpy().items()})
    gmean = np.random.default_rng(2).exponential(2e-4, 300).astype(
        np.float32)
    jnew, jstats = jt.densify_and_prune(jraw, jnp.asarray(gmean), **kw)
    tnew, tstats = tt.densify_and_prune(traw, torch.tensor(gmean), **kw)
    assert tstats == jstats
    assert tstats["cloned"] > 0 and tstats["split"] > 0
    for k in RAW:
        np.testing.assert_array_equal(getattr(tnew, k).numpy(),
                                      np.asarray(getattr(jnew, k)),
                                      err_msg=k)


FIT_KW = dict(steps=5, lr=1e-2, dssim_weight=0.2, lr_decay={"means": 0.1},
              opacity_reset_every=3, sh_warmup_every=2)


def test_dense_fit_matches_jax(problem):
    """5 dense steps with lr decay, an opacity reset and SH warmup: the
    loss history of both fits.  Adam divides by sqrt(second moment), which
    amplifies near-zero gradient components: rtol 1e-3."""
    d = problem["start"]
    cfg_kw = problem["cfg_kw"]
    jres = jt.fit(jax.tree.map(jnp.asarray, st.GaussianScene(**d)),
                  problem["jc"], problem["targets"],
                  config=st.RenderConfig(**cfg_kw), **FIT_KW)
    seen = []
    tres = tt.fit(stt.GaussianScene.from_numpy(d, device="cpu"),
                  problem["tc"], problem["targets"],
                  config=stt.RenderConfig(**cfg_kw),
                  progress_cb=lambda *a: seen.append(a), **FIT_KW)
    np.testing.assert_allclose(tres.losses.numpy(), np.asarray(jres.losses),
                               rtol=1e-3)
    # segments end at the SH degree step (2), the reset (3) and the end
    assert [s[0] for s in seen] == [2, 3, 5]
    assert tres.final_loss == float(tres.losses[-1])
    # the reset clamped every opacity at step 3; two steps move them little
    assert float(tres.scene.opacities.max()) < 0.05


TILED_FIT_KW = dict(steps=6, lr=1e-2, dssim_weight=0.2)


@pytest.fixture(scope="module")
def tiled_fit_ref(problem):
    """splat_tpu's tiled fit of the problem (its Pallas kernels in
    interpret mode): the one JAX reference of the tiled-fit pin."""
    d = problem["start"]
    res = jt.fit(jax.tree.map(jnp.asarray, st.GaussianScene(**d)),
                 problem["jc"], problem["targets"],
                 config=st.RenderConfig(**problem["cfg_kw"]),
                 method="tiled", **TILED_FIT_KW)
    return np.asarray(res.losses)


def test_tiled_fit_matches_jax(problem, tiled_fit_ref):
    """6 tiled steps (K3/K4's plain versions here, splat_tpu's Pallas
    kernels there): the loss histories within rtol 2e-4.  They drift
    apart through Adam's division by sqrt(second moment), which
    amplifies the kernels' f32 rounding in near-zero gradients: 5.9e-5
    at the sixth step on this problem."""
    d = problem["start"]
    res = tt.fit(stt.GaussianScene.from_numpy(d, device="cpu"),
                 problem["tc"], problem["targets"],
                 config=stt.RenderConfig(**problem["cfg_kw"]),
                 method="tiled", **TILED_FIT_KW)
    np.testing.assert_allclose(res.losses.numpy(), tiled_fit_ref,
                               rtol=2e-4)


def test_tiled_fit_converges(problem):
    d = problem["start"]
    res = stt.fit(stt.GaussianScene.from_numpy(d, device="cpu"),
                  problem["tc"], problem["targets"], steps=20, lr=1e-2,
                  config=stt.RenderConfig(**problem["cfg_kw"]),
                  method="tiled", dssim_weight=0.2)
    losses = res.losses.numpy()
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] / 2, losses


@pytest.mark.parametrize("bad", ["capacity", "mesh", "lr_key", "warmup"])
def test_fit_rejects(problem, bad):
    d = problem["start"]
    scene = stt.GaussianScene.from_numpy(d, device="cpu")
    kw = dict(steps=1, config=stt.RenderConfig(**problem["cfg_kw"]),
              method="tiled")
    err = ValueError
    if bad == "capacity":       # a truncated forward is never silent
        kw["config"] = stt.RenderConfig(max_dup_factor=0.5)
    elif bad == "mesh":         # not a (d, g) mesh from make_mesh
        kw["mesh"] = object()
    elif bad == "lr_key":
        kw["lr_scales"] = {"mean": 1.0}
    else:
        kw.update(loss_fn=lambda r: r.means.sum(), sh_warmup_every=2)
    with pytest.raises(err):
        stt.fit(scene, problem["tc"], problem["targets"], **kw)


def test_fit_auto_raises_capacity_after_densification(problem):
    """Densification shrinks k_cap = dup * N while the survivors keep their
    footprints: fit raises the capacity instead of truncating."""
    d = problem["start"]
    scene = stt.GaussianScene.from_numpy(d, device="cpu")
    need = tt._required_dup_factor(scene, problem["tc"],
                                   stt.RenderConfig())
    cfg = stt.RenderConfig(max_dup_factor=round(need + 0.01, 2))
    with pytest.warns(UserWarning, match="densification left"):
        res = stt.fit(scene, problem["tc"], problem["targets"], steps=2,
                      config=cfg, method="tiled", densify_every=1,
                      densify_kwargs=dict(min_opacity=0.5,
                                          grad_threshold=1.0,
                                          pad_multiple=1))
    assert res.densify_log[0]["pruned"] > 0
    assert np.isfinite(res.losses.numpy()).all()

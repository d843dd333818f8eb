"""The port's command line and viewer, run in process on the CPU
(``--device cpu``), against splat_tpu's on the same PLY and poses.

Tolerances: rendered PNGs >= 45 dB against splat_tpu.render at the same
pose; `info` and `psnr` print the same JSON; `trim` writes the same bytes;
the viewer's raw and PNG frames equal the port's own render at the pose
(uint8, exactly); every flag of `python -m splat_tpu` exists with the same
default."""

import argparse
import json
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch

import splat_tpu as st
import splat_tpu_torch as stt
from splat_tpu import cli as jax_cli
from splat_tpu.io.ply import load_ply as jax_load_ply
from splat_tpu.io.ply import save_ply as jax_save_ply
from splat_tpu.utils.image import read_png as jax_read_png
from splat_tpu_torch import cli
from splat_tpu_torch.utils.image import read_png, write_png
from splat_tpu_torch.viewer.server import make_server

torch.set_num_threads(1)

H, W = 96, 128
FX, FY, CX, CY = 150.0, 110.0, 70.0, 52.0
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def scene_ply(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    p = d / "scene.ply"
    jax_save_ply(p, st.surface_scene(512, seed=6, extent=1.5))
    return str(p)


def _rotmat_to_qvec(r):
    """Scalar-first unit quaternion of a 3x3 rotation (Shepperd)."""
    r = np.asarray(r, np.float64)
    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        q = [0.25 * s, (r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s,
             (r[1, 0] - r[0, 1]) / s]
    elif r[0, 0] > r[1, 1] and r[0, 0] > r[2, 2]:
        s = np.sqrt(1.0 + r[0, 0] - r[1, 1] - r[2, 2]) * 2
        q = [(r[2, 1] - r[1, 2]) / s, 0.25 * s, (r[0, 1] + r[1, 0]) / s,
             (r[0, 2] + r[2, 0]) / s]
    elif r[1, 1] > r[2, 2]:
        s = np.sqrt(1.0 + r[1, 1] - r[0, 0] - r[2, 2]) * 2
        q = [(r[0, 2] - r[2, 0]) / s, (r[0, 1] + r[1, 0]) / s, 0.25 * s,
             (r[1, 2] + r[2, 1]) / s]
    else:
        s = np.sqrt(1.0 + r[2, 2] - r[0, 0] - r[1, 1]) * 2
        q = [(r[1, 0] - r[0, 1]) / s, (r[0, 2] + r[2, 0]) / s,
             (r[1, 2] + r[2, 1]) / s, 0.25 * s]
    return [float(x) for x in q]


def _se3_spec(h=H, w=W):
    """A camera file of three rolled SE(3) views: view_matrix and COLMAP
    qvec/tvec forms mixed, fx != fy, off-centre principal point."""
    views = []
    for i, (pos, roll) in enumerate((((0.3, -0.6, 3.6), 0.3),
                                     ((-0.8, -0.4, 3.4), -0.2),
                                     ((0.9, -0.9, 3.3), 0.1))):
        v = np.asarray(st.Camera.create(h=h, w=w, position=pos)
                       .view_matrix(), np.float64)
        c, s = np.cos(roll), np.sin(roll)
        r = np.eye(4)
        r[:2, :2] = [[c, -s], [s, c]]
        v = r @ v
        if i == 1:      # COLMAP: y down, z forward
            flip = np.diag([1.0, -1.0, -1.0])
            views.append({"qvec": _rotmat_to_qvec(flip @ v[:3, :3]),
                          "tvec": (flip @ v[:3, 3]).tolist()})
        else:
            views.append({"view_matrix": v.tolist()})
    views[2]["fx"] = FX * 0.9
    return {"h": h, "w": w, "fx": FX, "fy": FY, "cx": CX, "cy": CY,
            "views": views}


def _jax_parser():
    """The parser splat_tpu.cli.main builds, caught before it parses."""
    class Caught(Exception):
        pass

    def catch(self, *a, **kw):
        raise Caught(self)

    real = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = catch
    try:
        jax_cli.main([])
    except Caught as e:
        return e.args[0]
    finally:
        argparse.ArgumentParser.parse_args = real
    raise AssertionError("splat_tpu.cli.main parsed without a parser")


def _flags(parser):
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {name: {a.dest: a.default for a in p._actions if a.dest != "help"}
            for name, p in sub.choices.items()}


def test_every_flag_and_default_of_splat_tpu():
    want, got = _flags(_jax_parser()), _flags(cli.build_parser())
    assert set(got) == set(want) == {"render", "orbit", "serve", "trim",
                                     "info", "bench", "fit", "psnr"}
    for cmd in want:
        extra = {"device": "cuda"} if cmd not in ("trim", "psnr") else {}
        g = {k: v for k, v in got[cmd].items() if k != "fn"}
        w_ = {k: v for k, v in want[cmd].items() if k != "fn"}
        assert g == {**w_, **extra}, cmd


def test_render_png_matches_splat_tpu(scene_ply, tmp_path, capsys):
    out = str(tmp_path / "r.png")
    pose = dict(position=(0.3, -0.6, 3.6), yaw=0.2, pitch=-0.1)
    rc = cli.main(["render", scene_ply, "--size", f"{W}x{H}", "--pos",
                   "0.3,-0.6,3.6", "--yaw", "0.2", "--pitch", "-0.1",
                   "--method", "tiled", "--stats", "--out", out, *CPU])
    assert rc == 0
    cap = capsys.readouterr()
    assert "auto dup-factor:" in cap.out and "Rendering took" in cap.out
    stats = json.loads(cap.err.strip().splitlines()[-1])
    assert stats["overflow"] == 0 and stats["num_pairs"] > 0
    got = read_png(out).astype(np.float32) / 255.0
    want = np.asarray(st.render(jax_load_ply(scene_ply),
                                st.Camera.create(h=H, w=W, **pose),
                                method="dense"))
    assert got.shape == (H, W, 3) and got.mean() > 0.01
    assert stt.psnr(got, want) >= 45.0


def test_render_naive_profile_writes_trace(tmp_path):
    out = str(tmp_path / "n.png")
    assert cli.main(["render", "--naive", "--size", "48x32",
                     "--pos=-0.57651054,2.99040512,-0.03924271", "--profile",
                     str(tmp_path / "prof"), "--out", out, *CPU]) == 0
    assert read_png(out).max() > 0
    (trace,) = os.listdir(tmp_path / "prof")
    assert json.loads((tmp_path / "prof" / trace).read_text())["traceEvents"]


def test_orbit_se3_path_and_gif(scene_ply, tmp_path, capsys):
    spec = tmp_path / "cams.json"
    spec.write_text(json.dumps(_se3_spec()))
    out_dir = tmp_path / "frames"
    rc = cli.main(["orbit", scene_ply, "--path", str(spec), "--out-dir",
                   str(out_dir), "--gif", str(tmp_path / "o.gif"),
                   "--method", "tiled", *CPU])
    assert rc == 0
    cap = capsys.readouterr()
    assert "wrote 3 frames" in cap.out and "WARNING" not in cap.err
    assert (tmp_path / "o.gif").read_bytes()[:6] == b"GIF89a"
    jscene = jax_load_ply(scene_ply)
    jcams, _, _ = jax_cli._load_camera_path(str(spec), "800x600", 90.0)
    for i, jc in enumerate(jcams):
        got = read_png(str(out_dir / f"frame_{i:04d}.png"))
        want = np.asarray(st.render(jscene, jc, method="dense"))
        assert got.mean() > 2
        assert stt.psnr(got.astype(np.float32) / 255.0, want) >= 45.0


def test_info_json_equals_splat_tpu(scene_ply, capsys):
    assert cli.main(["info", scene_ply, *CPU]) == 0
    got = json.loads(capsys.readouterr().out)
    assert jax_cli.main(["info", scene_ply]) == 0
    want = json.loads(capsys.readouterr().out)
    assert got == want and got["num_gaussians"] == 512


def test_trim_and_psnr_equal_splat_tpu(scene_ply, tmp_path, capsys):
    a, b = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
    assert cli.main(["trim", scene_ply, a, "--count", "5"]) == 0
    assert "wrote 5 splats" in capsys.readouterr().out
    assert jax_cli.main(["trim", scene_ply, b, "--count", "5"]) == 0
    assert open(a, "rb").read() == open(b, "rb").read()

    rng = np.random.default_rng(0)
    img = rng.random((H, W, 3)).astype(np.float32)
    pa, pb = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    write_png(pa, img)
    write_png(pb, np.clip(img + rng.normal(0, 0.02, img.shape), 0, 1))
    capsys.readouterr()
    for argv in ([pa, pb], [pa, pa]):
        assert cli.main(["psnr", *argv]) == 0
        got = capsys.readouterr().out
        assert jax_cli.main(["psnr", *argv]) == 0
        assert got == capsys.readouterr().out


def test_bench_refuses_the_cpu(capsys):
    with pytest.raises(SystemExit, match="card"):
        cli.main(["bench", "--n", "64", "--size", "64x48", "--frames", "2",
                  *CPU])


def test_device_cuda_without_a_card_fails(scene_ply, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["render", scene_ply, "--out", str(tmp_path / "x.png")])


def test_fit_targets_with_se3_cameras(tmp_path, capsys):
    h, w = 48, 64
    spec = _se3_spec(h, w)
    for v in spec["views"]:
        v.pop("fx", None)
    spec.update(fx=FX / 2, fy=FY / 2, cx=CX / 2, cy=CY / 2)
    (tmp_path / "cams.json").write_text(json.dumps(spec))
    cams, _, _ = cli._load_camera_path(str(tmp_path / "cams.json"),
                                       "800x600", 90.0, device="cpu")
    truth = stt.surface_scene(256, seed=2, extent=1.5, device="cpu")
    tdir = tmp_path / "targets"
    tdir.mkdir()
    for i, c in enumerate(cams):
        write_png(str(tdir / f"t{i}.png"), stt.render_dense(truth, c))
    out = str(tmp_path / "fit.ply")
    rc = cli.main(["fit", "--targets", str(tdir), "--cameras",
                   str(tmp_path / "cams.json"), "--init-n", "256",
                   "--steps", "6", "--lr", "0.02", "--dup-factor", "8",
                   "--out", out, *CPU])
    assert rc == 0
    line = next(s for s in capsys.readouterr().out.splitlines()
                if s.startswith("fit in"))
    first, last = (float(x) for x in
                   line.split("loss ")[1].split(" (")[0].split(" -> "))
    assert last < first
    assert stt.load_ply(out, center=False, device="cpu").num_gaussians == 256


def test_fit_distill(scene_ply, tmp_path, capsys):
    out = str(tmp_path / "d.ply")
    rc = cli.main(["fit", "--distill", scene_ply, "--views", "2", "--size",
                   "64x48", "--init-n", "128", "--steps", "3", "--out", out,
                   *CPU])
    assert rc == 0
    text = capsys.readouterr().out
    assert "rendering 2 target views" in text and "reconstruction PSNR" in text
    assert stt.load_ply(out, center=False, device="cpu").num_gaussians == 128


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=120) as r:
        return r.read(), dict(r.headers)


def test_viewer_serves_page_raw_and_png(scene_ply, tmp_path):
    scene = stt.load_ply(scene_ply, device="cpu")
    cam = stt.Camera.create(h=H, w=W, position=(0.0, -0.5, 4.0),
                            device="cpu")
    cfg = stt.RenderConfig(max_dup_factor=4.0)
    srv = make_server(scene, cam, cfg, port=0, method="tiled")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        port = srv.server_address[1]
        page, _ = _get(port, "/")
        assert b"splat_tpu viewer" in page and f'width="{W}"'.encode() in page
        raw, hdr = _get(port, "/frame.raw?yaw=0.3&pitch=0.1&dist=1.2")
        assert hdr["X-Splat-Overflow"] == "0"
        assert (hdr["X-Splat-W"], hdr["X-Splat-H"]) == (str(W), str(H))
        pos = np.asarray([0.0, -0.5, 4.0], np.float32) * np.float32(1.2)
        want = stt.render_tiled(scene, cam.with_pose(yaw=0.3, pitch=0.1,
                                                     position=pos), cfg)
        want = (torch.clamp(want, 0, 1) * 255 + 0.5).to(torch.uint8).numpy()
        got = np.frombuffer(raw, np.uint8).reshape(H, W, 4)
        np.testing.assert_array_equal(got[..., :3], want)
        assert (got[..., 3] == 255).all()
        png, hdr = _get(port, "/frame.png?yaw=0.3&pitch=0.1&dist=1.2")
        assert hdr["Content-Type"] == "image/png"
        (tmp_path / "f.png").write_bytes(png)
        np.testing.assert_array_equal(jax_read_png(str(tmp_path / "f.png")),
                                      want)
        for q, size in (("mode=depth", (W, H)), ("scale=0.5", (W // 2, H // 2)),
                        ("scale=2.0", (2 * W, 2 * H))):
            body, hdr = _get(port, f"/frame.raw?{q}")
            assert hdr["X-Splat-Overflow"] == "0", q
            assert (int(hdr["X-Splat-W"]), int(hdr["X-Splat-H"])) == size
            assert len(body) == size[0] * size[1] * 4
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)
    assert not t.is_alive()

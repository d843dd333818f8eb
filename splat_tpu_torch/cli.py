"""Command-line interface (port of ``splat_tpu.cli``).

    python -m splat_tpu_torch <render|orbit|serve|trim|info|bench|fit|psnr>

Every subcommand and flag of ``python -m splat_tpu``, with the same
defaults and printed lines:
  render  one frame from a pose to a PNG
  orbit   a camera trajectory (yaw/pitch orbit or a JSON camera path) to
          PNG frames, optionally a GIF
  serve   the interactive browser viewer
  trim    cut a PLY down to a small fixture
  info    scene statistics as JSON
  bench   timed yaw sweep on the card
  fit     optimise a scene against target images (distil a model, or fit
          PNGs with a JSON camera file of orbit or SE(3) views)
  psnr    compare two PNGs
One flag is the port's own: ``--device`` (default ``cuda``, which fails
without a card; ``--device cpu`` runs the kernels' plain versions) on the
subcommands that put a scene somewhere.  ``trim`` and ``psnr`` only read
and write files.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time


def _add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="where the scene lives and the frames render: "
                        "'cuda' (default; fails without a CUDA device), "
                        "'cuda:N' or 'cpu' (the kernels' plain PyTorch "
                        "versions)")


def _add_render_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--size", default="800x600",
                   help="WxH (reference viewer default 800x600, "
                        "src/main.rs:9-10)")
    p.add_argument("--pos", default="0,0,5",
                   help="camera position (reference src/main.rs:13)")
    p.add_argument("--target", default="0,0,0")
    p.add_argument("--yaw", type=float, default=0.0)
    p.add_argument("--pitch", type=float, default=0.0)
    p.add_argument("--fovy-deg", type=float, default=90.0)
    p.add_argument("--sh-degree", type=int, default=3)
    p.add_argument("--lowpass", type=float, default=0.3)
    p.add_argument("--tile", type=int, default=32,
                   help="tile width in pixels (and height unless --tile-y)")
    p.add_argument("--tile-y", type=int, default=0,
                   help="tile height in pixels (0 = square tiles)")
    p.add_argument("--dup-factor", default="auto",
                   help="duplication-buffer capacity as a multiple of N. "
                        "Default 'auto': measure the scene's pair load at "
                        "the given pose and add 25%% headroom. Fractional "
                        "explicit values are fine; raise on overflow "
                        "warnings (overflow is always detected, never "
                        "silent)")
    p.add_argument("--background", default="0,0,0")
    p.add_argument("--alpha", action="store_true",
                   help="output RGBA: the alpha channel is the accumulated "
                        "per-pixel coverage 1 - T (PNGs are written as "
                        "color-type-6 RGBA)")
    p.add_argument("--render-mode", choices=["color", "depth"],
                   default="color",
                   help="what the composited channels carry: 'color' "
                        "(SH RGB) or 'depth' (alpha-weighted expected "
                        "view depth as a grayscale map; pair with "
                        "--alpha to recover mean depth)")
    p.add_argument("--depth-range", default=None, metavar="NEAR,FAR",
                   help="view-depth range mapped to [0,1] in depth mode "
                        "(default: each frame's visible min/max; pin an "
                        "explicit range for stable orbits)")
    p.add_argument("--supersample", type=int, default=1, metavar="K",
                   help="anti-aliasing: render at KxK the resolution and "
                        "box-filter down; cost scales ~K^2")
    p.add_argument("--sigma-cutoff", default="3.0",
                   help="bbox radius in standard deviations (reference: "
                        "3-sigma quads); 'inf' = truncation-free mode "
                        "(requires tight radii)")
    p.add_argument("--binning-key", choices=["rank", "depth"],
                   default=None,
                   help="pair sort-key low bits (default: the "
                        "RenderConfig default); on the card both give the "
                        "exact front-to-back order")
    p.add_argument("--method", choices=["auto", "dense", "tiled"],
                   default="auto")
    p.add_argument("--profile", metavar="LOGDIR", default=None,
                   help="write a torch.profiler Chrome trace of the render "
                        "into LOGDIR")
    p.add_argument("--no-center", action="store_true",
                   help="skip mean-centering positions at load")
    p.add_argument("--naive", action="store_true",
                   help="use the built-in 4-gaussian fixture instead of a "
                        "PLY (reference 01_naive_gaussian.rs)")
    _add_device_flag(p)


def _parse_vec(s: str, n: int) -> tuple[float, ...]:
    v = tuple(float(x) for x in s.split(","))
    if len(v) != n:
        raise SystemExit(f"expected {n} comma-separated floats, got {s!r}")
    return v


def _device(args):
    """The --device as a torch.device; a CUDA device that is not there
    stops the command (no quiet move to the CPU)."""
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is "
                         f"available (pass --device cpu to run on the CPU)")
    return dev


def _load(args, device):
    from splat_tpu_torch.io.cache import load_scene_cached
    from splat_tpu_torch.utils.fixtures import naive_gaussians

    if args.naive:
        return naive_gaussians(device=device)
    if not args.scene:
        raise SystemExit("a scene .ply is required (or pass --naive)")
    return load_scene_cached(args.scene, center=not args.no_center,
                             device=device)


def _camera(args, device):
    from splat_tpu_torch.camera import Camera

    w, h = (int(x) for x in args.size.split("x"))
    return Camera.create(
        h=h, w=w, position=_parse_vec(args.pos, 3),
        target=_parse_vec(args.target, 3), yaw=args.yaw, pitch=args.pitch,
        fovy=math.radians(args.fovy_deg), device=device)


def _load_camera_path(path: str, size: str, fovy_deg: float,
                      interp: int = 1, device=None):
    """Camera list from the JSON spec shared by `fit` and `orbit --path`:

      {"h": 300, "w": 400, "fovy_deg": 90.0, "views": [
         {"position": [x,y,z], "target": [0,0,0],
          "yaw": 0.0, "pitch": 0.0}, ...]}

    or, for arbitrary SE(3) poses (COLMAP-style captures an orbit cannot
    express), views of either form

      {"view_matrix": [[...4 rows of 4...]], "fx": F, "fy": F,
       "cx": C, "cy": C}                       # engine look_at frame
      {"qvec": [w,x,y,z], "tvec": [x,y,z], "fx": ..., ...}  # COLMAP w2c

    (fx/fy/cx/cy may also be given once at the top level; they default to
    the fovy-derived focal and the image centre).  Orbit and SE(3) views
    cannot be mixed in one file.

    Returns (cam_list, h, w).  interp > 1 linearly interpolates that many
    frames between consecutive orbit waypoints (position/target/yaw/pitch);
    SE(3) poses have no canonical linear interpolation."""
    import numpy as np

    from splat_tpu_torch.camera import Camera, SE3Camera

    with open(path) as f:
        spec = json.load(f)
    w, h = (int(x) for x in size.split("x"))
    h, w = int(spec.get("h", h)), int(spec.get("w", w))
    fovy = math.radians(float(spec.get("fovy_deg", fovy_deg)))
    vs = spec["views"]
    if not vs:
        raise SystemExit(f"{path}: empty views list")
    se3 = [("view_matrix" in v) or ("qvec" in v) for v in vs]
    if any(se3):
        if not all(se3):
            raise SystemExit(f"{path}: cannot mix orbit views and "
                             f"view_matrix/qvec views in one file")
        if interp > 1:
            raise SystemExit("--interp needs orbit views (no canonical "
                             "lerp on SE(3) poses)")
        focal_default = h / (2.0 * np.tan(fovy / 2))

        def intr(v):
            fx = float(v.get("fx", spec.get("fx", focal_default)))
            fy = float(v.get("fy", spec.get("fy", fx)))
            cx = float(v.get("cx", spec.get("cx", w / 2)))
            cy = float(v.get("cy", spec.get("cy", h / 2)))
            return fx, fy, cx, cy

        cams = []
        for v in vs:
            fx, fy, cx, cy = intr(v)
            if "view_matrix" in v:
                m = np.asarray(v["view_matrix"], np.float32)
                if m.shape != (4, 4):
                    raise SystemExit(f"{path}: view_matrix must be 4x4, "
                                     f"got {m.shape}")
                cams.append(SE3Camera.create(h=h, w=w, view=m, fx=fx, fy=fy,
                                             cx=cx, cy=cy, device=device))
            else:
                cams.append(SE3Camera.from_colmap(
                    v["qvec"], v["tvec"], fx, fy, cx, cy, h, w,
                    device=device))
        return cams, h, w
    pos = np.asarray([v["position"] for v in vs], np.float32)
    tgt = np.asarray([v.get("target", (0.0, 0.0, 0.0)) for v in vs],
                     np.float32)
    yaw = np.asarray([v.get("yaw", 0.0) for v in vs], np.float32)
    pitch = np.asarray([v.get("pitch", 0.0) for v in vs], np.float32)
    if interp > 1 and len(vs) > 1:
        t = np.arange(len(vs), dtype=np.float32)
        tq = np.linspace(0.0, len(vs) - 1.0,
                         (len(vs) - 1) * interp + 1).astype(np.float32)

        def lerp(a):
            if a.ndim == 2:
                return np.stack([np.interp(tq, t, a[:, i])
                                 for i in range(a.shape[1])],
                                axis=-1).astype(np.float32)
            return np.interp(tq, t, a).astype(np.float32)

        pos, tgt, yaw, pitch = lerp(pos), lerp(tgt), lerp(yaw), lerp(pitch)
    cams = [Camera.create(h=h, w=w, position=tuple(p), target=tuple(g),
                          yaw=float(y), pitch=float(q), fovy=fovy,
                          device=device)
            for p, g, y, q in zip(pos, tgt, yaw, pitch)]
    return cams, h, w


def _config(args, scene=None, cam=None):
    from splat_tpu_torch.config import RenderConfig

    sigma = float(getattr(args, "sigma_cutoff", "3.0"))  # 'inf' parses
    bkey = (getattr(args, "binning_key", None)
            or RenderConfig.binning_key)
    mode = getattr(args, "render_mode", "color")
    drange = getattr(args, "depth_range", None)
    drange = _parse_vec(drange, 2) if drange else None
    dup = getattr(args, "dup_factor", "auto")
    if dup == "auto":
        if scene is None or cam is None:
            raise SystemExit("--dup-factor auto needs a scene and pose")
        from splat_tpu_torch.render.api import pair_stats, resolve_method
        if resolve_method(getattr(args, "method", "auto"), scene) == "dense":
            return RenderConfig(  # dense path has no duplication buffer
                sh_degree=args.sh_degree, lowpass=args.lowpass,
                tile_px=args.tile, tile_py=args.tile_y,
                sigma_cutoff=sigma, binning_key=bkey,
                alpha_channel=getattr(args, "alpha", False),
                supersample=getattr(args, "supersample", 1),
                render_mode=mode, depth_range=drange,
                background=_parse_vec(args.background, 3))
        base = RenderConfig(sh_degree=args.sh_degree, lowpass=args.lowpass,
                            tile_px=args.tile, tile_py=args.tile_y,
                            sigma_cutoff=sigma, binning_key=bkey,
                            supersample=getattr(args, "supersample", 1),
                            background=_parse_vec(args.background, 3))
        stats = pair_stats(scene, cam, base)
        dup = stats["suggested_dup_factor"]
        print(f"auto dup-factor: {stats['num_pairs']} pairs "
              f"({stats['pairs_per_gaussian']:.2f}/gaussian) -> "
              f"max_dup_factor={dup}")
    return RenderConfig(sh_degree=args.sh_degree, lowpass=args.lowpass,
                        tile_px=args.tile, tile_py=args.tile_y,
                        max_dup_factor=float(dup), sigma_cutoff=sigma,
                        alpha_channel=getattr(args, "alpha", False),
                        binning_key=bkey,
                        supersample=getattr(args, "supersample", 1),
                        render_mode=mode, depth_range=drange,
                        background=_parse_vec(args.background, 3))


def cmd_render(args) -> int:
    import torch

    from splat_tpu_torch.render.api import render, resolve_method
    from splat_tpu_torch.utils.image import write_png

    dev = _device(args)
    scene = _load(args, dev)
    cam = _camera(args, dev)
    config = _config(args, scene, cam)
    scene = scene.pack_device()   # the feature-major layout, packed once
    t0 = time.time()
    if args.profile:
        from splat_tpu_torch.utils.diagnostics import profile_trace
        ctx = profile_trace(args.profile)
    else:
        ctx = contextlib.nullcontext()
    with ctx, torch.inference_mode():
        img = render(scene, cam, config, method=args.method).cpu().numpy()
    # the reference prints per-frame timing (src/main.rs:77)
    print(f"Rendering took {(time.time() - t0) * 1e3:.1f} ms "
          f"(N={scene.num_gaussians}, {cam.w}x{cam.h}, incl. compile)")
    if args.stats:
        if resolve_method(args.method, scene) == "tiled":
            from splat_tpu_torch.utils.diagnostics import frame_report
            print(json.dumps(frame_report(scene, cam, config)),
                  file=sys.stderr)
        else:
            print("--stats: dense path has no binning stats",
                  file=sys.stderr)
    write_png(args.out, img)
    print(f"wrote {args.out}")
    return 0


def cmd_orbit(args) -> int:
    import torch

    from splat_tpu_torch.camera import orbit_trajectory
    from splat_tpu_torch.render.api import render_fn, resolve_method
    from splat_tpu_torch.render.tiled import render_tiled
    from splat_tpu_torch.utils.image import write_png

    dev = _device(args)
    scene = _load(args, dev)
    if args.path:
        cams, _, _ = _load_camera_path(args.path, args.size, args.fovy_deg,
                                       interp=args.interp, device=dev)
        cam = cams[0]
    else:
        cam = _camera(args, dev)
        cams = orbit_trajectory(
            cam, args.frames, yaw_sweep=math.radians(args.yaw_sweep),
            pitch_sweep=math.radians(args.pitch_sweep))
    n_frames = len(cams)
    os.makedirs(args.out_dir, exist_ok=True)
    config = _config(args, scene, cam)
    scene = scene.pack_device()   # the feature-major layout, packed once
    tiled = resolve_method(args.method, scene) == "tiled"
    f = render_fn(args.method, config)
    # each frame's overflow stays on the device; one read after the loop,
    # so a truncated frame is reported and no frame waits for it
    overflows = []
    gif_frames = [] if args.gif else None
    t0 = time.time()
    with torch.inference_mode():
        for i, c in enumerate(cams):
            if tiled:
                img, stats = render_tiled(scene, c, config,
                                          return_stats=True)
                overflows.append(stats["overflow"])
            else:
                img = f(scene, c)
            img = img.cpu().numpy()
            write_png(os.path.join(args.out_dir, f"frame_{i:04d}.png"), img,
                      level=args.png_level)
            if gif_frames is not None:
                gif_frames.append(img)
            if i == 0:
                t0 = time.time()  # the first frame builds the kernels
    steady = n_frames - 1
    if steady > 0:
        dt = (time.time() - t0) / steady
        print(f"{steady} frames: {dt * 1e3:.1f} ms/frame "
              f"({1.0 / dt:.1f} FPS incl. host I/O)")
    if overflows:
        overflow_max = int(torch.stack(overflows).max())
        if overflow_max > 0:
            print(f"WARNING: duplication-buffer overflow ({overflow_max} "
                  f"pairs dropped in the worst frame) — frames are "
                  f"truncated; raise --dup-factor", file=sys.stderr)
    if gif_frames is not None:
        from splat_tpu_torch.utils.gif import write_gif
        write_gif(args.gif, gif_frames, fps=args.gif_fps)
        print(f"wrote {args.gif}")
    print(f"wrote {n_frames} frames to {args.out_dir}/")
    return 0


def cmd_trim(args) -> int:
    from splat_tpu_torch.io.ply import trim_ply

    n = trim_ply(args.scene, args.out, count=args.count)
    print(f"wrote {n} splats to {args.out}")
    return 0


def _sh_nonzero_bands(sh) -> int:
    """Highest SH band with any nonzero rest coefficient: rest slots 0-2
    are band 1, 3-7 band 2, 8-14 band 3 (slot 0 of the 16 is the DC
    term)."""
    import numpy as np

    rest_nonzero = (sh[:, 1:, :] != 0).any(axis=(0, 2))      # (15,)
    if not rest_nonzero.any():
        return 0
    k = int(np.flatnonzero(rest_nonzero)[-1])
    return 1 if k < 3 else 2 if k < 8 else 3


def cmd_info(args) -> int:
    import numpy as np

    scene = _load(args, _device(args))
    d = scene.to_numpy()
    memory_mb = round(sum(a.nbytes for a in d.values()) / 2 ** 20, 1)
    if scene.num_gaussians == 0:   # reductions below have no identity
        print(json.dumps({"num_gaussians": 0, "memory_mb": memory_mb},
                         indent=2))
        return 0
    stats = {
        "num_gaussians": int(scene.num_gaussians),
        "extent": {
            "min": d["means"].min(0).tolist(),
            "max": d["means"].max(0).tolist(),
        },
        "scales": {"mean": float(d["scales"].mean()),
                   "p50": float(np.median(d["scales"])),
                   "max": float(d["scales"].max())},
        "opacity": {"mean": float(d["opacities"].mean()),
                    "p50": float(np.median(d["opacities"]))},
        "sh_nonzero_bands": _sh_nonzero_bands(d["sh"]),
        "memory_mb": memory_mb,
    }
    print(json.dumps(stats, indent=2))
    return 0


def cmd_bench(args) -> int:
    from splat_tpu_torch.utils.benchmark import chained_bench
    from splat_tpu_torch.utils.fixtures import random_scene

    dev = _device(args)
    if dev.type != "cuda":
        raise SystemExit("bench times the card: it needs --device cuda")
    if args.naive or args.scene:
        scene = _load(args, dev)
    else:
        scene = random_scene(args.n, seed=0, device=dev)
        print(f"synthetic scene: N={args.n}")
    cam = _camera(args, dev)
    config = _config(args, scene, cam)
    r = chained_bench(scene.pack_device(), cam, config, args.frames)
    print(f"compile: {r['warmup_s']:.1f}s")
    print(f"{args.frames} frames (device-chained, yaw sweep): "
          f"{r['ms_per_frame']:.2f} ms/frame ({r['fps']:.1f} FPS)")
    per = r["num_pairs"] / max(scene.num_gaussians, 1)
    print(f"pairs={r['num_pairs']} visible={r['visible']} "
          f"overflow={r['overflow']} pairs/gaussian={per:.2f} "
          f"(suggested --dup-factor {max(1.25, round(per * 1.25, 2))})")
    if r["overflow"] > 0:
        print("WARNING: overflow > 0 — the timing above measures a "
              "truncated render; raise --dup-factor", file=sys.stderr)
    return 0


def cmd_fit(args) -> int:
    """Optimise a scene against target images.

    Two target sources:
      --distill REF.ply : render the targets from an existing model over
        an orbit (compress or distil a big model into a smaller one);
      --targets DIR --cameras FILE.json : fit a directory of PNG images
        with poses from a camera file (orbit or SE(3) views, see
        ``_load_camera_path``; views pair with the *.png sorted by name).
    """
    import dataclasses

    import numpy as np
    import torch

    from splat_tpu_torch.camera import Camera, orbit_trajectory, stack_cameras
    from splat_tpu_torch.config import RenderConfig
    from splat_tpu_torch.io.cache import load_scene_cached
    from splat_tpu_torch.io.ply import save_ply
    from splat_tpu_torch.render.api import render, resolve_method
    from splat_tpu_torch.train import fit
    from splat_tpu_torch.utils.fixtures import random_scene
    from splat_tpu_torch.utils.image import psnr, read_png

    dev = _device(args)
    w, h = (int(x) for x in args.size.split("x"))
    cfg = RenderConfig(max_dup_factor=float(args.dup_factor),
                       sh_degree=args.sh_degree)

    # ---- targets and cameras ----------------------------------------------
    ref = None
    if args.distill:
        # center=False: the fitted scene must live in REF's coordinates
        ref = load_scene_cached(args.distill, center=False, device=dev)
        # pack once where the tiled path renders the targets (the dense
        # path takes the GaussianScene as it is)
        ref_render = (ref.pack_device()
                      if resolve_method(args.method, ref) == "tiled"
                      else ref)
        base = Camera.create(h=h, w=w, position=_parse_vec(args.pos, 3),
                             target=_parse_vec(args.target, 3),
                             fovy=math.radians(args.fovy_deg), device=dev)
        cams = orbit_trajectory(base, num_frames=args.views,
                                yaw_sweep=math.radians(args.yaw_sweep),
                                pitch_sweep=math.radians(args.pitch_sweep))
        print(f"rendering {args.views} target views from "
              f"{args.distill} at {w}x{h}...")
        with torch.no_grad():     # fit's loss saves them for backward
            targets = torch.stack([render(ref_render, c,
                                          method=args.method)
                                   for c in cams])
    elif args.targets:
        if not args.cameras:
            raise SystemExit("--targets needs --cameras FILE.json")
        cl, h, w = _load_camera_path(args.cameras, args.size, args.fovy_deg,
                                     device=dev)
        files = sorted(
            os.path.join(args.targets, n) for n in os.listdir(args.targets)
            if n.lower().endswith(".png"))
        if len(files) != len(cl):
            raise SystemExit(f"{len(files)} PNGs in {args.targets} but "
                             f"{len(cl)} views in {args.cameras}")
        imgs = []
        for p in files:
            img = read_png(p)[:, :, :3].astype(np.float32) / 255.0
            if img.shape[:2] != (h, w):
                raise SystemExit(f"{p} is {img.shape[1]}x{img.shape[0]}, "
                                 f"cameras say {w}x{h}")
            imgs.append(img)
        targets = torch.tensor(np.stack(imgs), device=dev)
        cams = stack_cameras(cl)
    else:
        raise SystemExit("pass --distill REF.ply or --targets DIR")

    # ---- initialisation ---------------------------------------------------
    if args.init:
        start = load_scene_cached(args.init, center=False, device=dev)
    else:
        start = random_scene(args.init_n, seed=args.seed, extent=1.0,
                             device=dev)
        if ref is not None:  # place the random ball over REF's extent
            means = ref.means.cpu().numpy()
            center = means.mean(axis=0)
            extent = float(np.percentile(
                np.linalg.norm(means - center, axis=1), 95))
            start = dataclasses.replace(
                start,
                means=start.means * extent + torch.tensor(center,
                                                          device=dev),
                scales=start.scales * extent)

    # ---- optimise ---------------------------------------------------------
    print(f"fitting {start.num_gaussians} splats to {targets.shape[0]} "
          f"views ({w}x{h}), {args.steps} steps, method={args.fit_method}, "
          f"l1={args.l1}, dssim={args.dssim}"
          + (f", densify every {args.densify_every}"
             if args.densify_every else ""))
    t0 = time.time()
    res = fit(start, cams, targets, steps=args.steps, lr=args.lr,
              config=cfg, method=args.fit_method, l1_weight=args.l1,
              dssim_weight=args.dssim,
              lr_decay=({"means": args.means_lr_decay}
                        if args.means_lr_decay != 1.0 else None),
              densify_every=args.densify_every,
              opacity_reset_every=args.opacity_reset_every,
              sh_warmup_every=args.sh_warmup_every,
              progress_cb=lambda s, l, n: print(
                  f"  step {s}/{args.steps}: loss {l:.5f} "
                  f"({n} gaussians)", flush=True))
    dt = time.time() - t0
    first, last = float(res.losses[0]), float(res.losses[-1])
    print(f"fit in {dt:.0f}s: loss {first:.5f} -> {last:.5f} "
          f"({first / max(last, 1e-12):.1f}x)")
    for rnd in res.densify_log:
        print(f"  densify: {rnd}")

    with torch.inference_mode():
        ps = [psnr(render(res.scene, c, method=args.method,
                          check_overflow=False), t)
              for c, t in zip(cams, targets)]
    print(f"reconstruction PSNR vs targets: mean {np.mean(ps):.2f} dB "
          f"(per view: {', '.join(f'{p:.1f}' for p in ps)})")
    save_ply(args.out, res.scene)
    print(f"wrote {args.out} ({res.scene.num_gaussians} gaussians)")
    return 0


def cmd_psnr(args) -> int:
    """Compare two PNGs: one JSON line with psnr/mse/max-abs, the suite's
    parity metric as a shell tool."""
    import numpy as np

    from splat_tpu_torch.utils.image import psnr, read_png

    a = read_png(args.a).astype(np.float32) / 255.0
    b = read_png(args.b).astype(np.float32) / 255.0
    if a.shape[-1] != b.shape[-1]:  # RGB vs RGBA: compare colour planes
        a, b = a[..., :3], b[..., :3]
    if a.shape != b.shape:
        raise SystemExit(f"shape mismatch: {args.a} {a.shape} vs "
                         f"{args.b} {b.shape}")
    diff = np.abs(a - b)
    p = float(psnr(a, b))
    print(json.dumps({
        # an exact match clamps to 999.0: float('inf') would serialise as
        # the bare token `Infinity`, which strict JSON parsers reject
        "psnr_db": round(p, 3) if math.isfinite(p) else 999.0,
        "mse": float(np.mean(diff * diff)),
        "max_abs": float(diff.max()),
        "shape": list(a.shape),
    }))
    return 0


def cmd_serve(args) -> int:
    from splat_tpu_torch.viewer.server import serve

    dev = _device(args)
    scene = _load(args, dev)
    cam = _camera(args, dev)
    serve(scene, cam, _config(args, scene, cam), host=args.host,
          port=args.port, method=args.method, png_level=args.png_level,
          transport=args.transport)
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="splat_tpu_torch",
        description="3D gaussian splatting renderer (PyTorch + CUDA)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="render one frame to a PNG")
    p.add_argument("scene", nargs="?", help="3DGS .ply")
    _add_render_flags(p)
    p.add_argument("--out", default="frame.png")
    p.add_argument("--stats", action="store_true",
                   help="print the frame report (visible/pair counts, "
                        "tile occupancy, overflow) as JSON on stderr — "
                        "deployment capacity sizing")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("orbit", help="render an orbit trajectory")
    p.add_argument("scene", nargs="?")
    _add_render_flags(p)
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--yaw-sweep", type=float, default=360.0,
                   help="total yaw sweep in degrees")
    p.add_argument("--pitch-sweep", type=float, default=0.0)
    p.add_argument("--path", metavar="FILE.json", default=None,
                   help="render a custom camera path instead of the "
                        "yaw/pitch orbit: same JSON spec as `fit "
                        "--cameras` (orbit or SE(3) views); overrides "
                        "--frames/--size/--pos")
    p.add_argument("--interp", type=int, default=1, metavar="K",
                   help="with --path: linearly interpolate K frames "
                        "between consecutive waypoints (keyframes -> "
                        "smooth flythrough)")
    p.add_argument("--out-dir", default="frames")
    p.add_argument("--png-level", type=int, default=6,
                   help="zlib level for frame PNGs (lower = faster export, "
                        "bigger files; 0 = stored)")
    p.add_argument("--gif", default=None,
                   help="also write an animated GIF to this path")
    p.add_argument("--gif-fps", type=float, default=20.0)
    p.set_defaults(fn=cmd_orbit)

    p = sub.add_parser("trim", help="copy the first K splats to a fixture")
    p.add_argument("scene")
    p.add_argument("out")
    p.add_argument("--count", type=int, default=3)
    p.set_defaults(fn=cmd_trim)

    p = sub.add_parser("info", help="scene statistics")
    p.add_argument("scene", nargs="?")
    p.add_argument("--naive", action="store_true")
    p.add_argument("--no-center", action="store_true")
    _add_device_flag(p)
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("serve", help="interactive browser viewer "
                       "(arrow keys / drag / wheel, like the reference "
                       "viewer)")
    p.add_argument("scene", nargs="?")
    _add_render_flags(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--png-level", type=int, default=0,
                   help="zlib level for served PNG frames (0 = stored "
                        "blocks: fastest encode, most bytes; raise for "
                        "remote viewing on thin links)")
    p.add_argument("--transport", choices=["raw", "png"], default="raw",
                   help="initial frame transport ('T' toggles in the "
                        "browser): raw RGBA into a canvas (no encode or "
                        "decode; localhost default) or PNG at "
                        "--png-level (thin links)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("fit", help="optimize a scene against target "
                       "images (distill an existing model or fit a "
                       "PNG+camera dataset)")
    p.add_argument("--distill", metavar="REF.ply", default=None,
                   help="render the targets from this model over an "
                        "orbit (scene compression/distillation)")
    p.add_argument("--targets", metavar="DIR", default=None,
                   help="directory of target PNGs (sorted by name)")
    p.add_argument("--cameras", metavar="FILE.json", default=None,
                   help="camera spec for --targets: {h, w, fovy_deg, "
                        "views: [...]} with orbit views {position, target, "
                        "yaw, pitch} or SE(3) views {view_matrix | qvec, "
                        "tvec; fx, fy, cx, cy}")
    p.add_argument("--init", metavar="INIT.ply", default=None,
                   help="initial scene (default: random init sized to "
                        "the distill model's extent)")
    p.add_argument("--init-n", type=int, default=20_000,
                   help="random-init gaussian count (without --init)")
    p.add_argument("--out", default="fitted.ply")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--l1", type=float, default=0.2)
    p.add_argument("--dssim", type=float, default=0.2)
    p.add_argument("--fit-method", choices=["dense", "tiled"],
                   default="tiled",
                   help="gradient path: the tiled path on the training "
                        "kernels (scales to millions of splats) or the "
                        "exact dense path (small scenes)")
    p.add_argument("--method", choices=["auto", "dense", "tiled"],
                   default="auto", help="forward path for target "
                   "rendering / PSNR reporting")
    p.add_argument("--views", type=int, default=4,
                   help="orbit views for --distill")
    p.add_argument("--yaw-sweep", type=float, default=45.0,
                   help="distill orbit yaw sweep (degrees)")
    p.add_argument("--pitch-sweep", type=float, default=10.0)
    p.add_argument("--size", default="400x300")
    p.add_argument("--pos", default="0,-1,3.5")
    p.add_argument("--target", default="0,0,0")
    p.add_argument("--fovy-deg", type=float, default=90.0)
    p.add_argument("--sh-degree", type=int, default=3)
    p.add_argument("--dup-factor", type=float, default=4.0,
                   help="duplication capacity for the tiled path (fit "
                        "audits it against every view)")
    p.add_argument("--densify-every", type=int, default=0,
                   help="adaptive density control (clone/split/prune) "
                        "every K steps (0 = off)")
    p.add_argument("--sh-warmup-every", type=int, default=0,
                   help="INRIA recipe: start at SH degree 0 and raise "
                        "the active degree by one every K steps up to "
                        "--sh-degree (0 = no warmup)")
    p.add_argument("--opacity-reset-every", type=int, default=0,
                   help="INRIA recipe: every K steps clamp all opacities "
                        "to <= 0.01 so floaters must re-earn their alpha "
                        "(pair with --densify-every; 0 = off)")
    p.add_argument("--means-lr-decay", type=float, default=0.01,
                   help="total exponential decay of the positional lr "
                        "over the run (the INRIA recipe's position "
                        "schedule: 1.6e-4 -> 1.6e-6 is 0.01); 1.0 = "
                        "constant lr")
    p.add_argument("--seed", type=int, default=0)
    _add_device_flag(p)
    p.set_defaults(fn=cmd_fit)

    p = sub.add_parser("psnr", help="compare two PNGs (PSNR/MSE/max-abs "
                       "as one JSON line)")
    p.add_argument("a")
    p.add_argument("b")
    p.set_defaults(fn=cmd_psnr)

    p = sub.add_parser("bench", help="timed yaw sweep on the card")
    p.add_argument("scene", nargs="?")
    _add_render_flags(p)
    p.add_argument("--n", type=int, default=100_000,
                   help="synthetic scene size when no PLY given")
    p.add_argument("--frames", type=int, default=20)
    p.set_defaults(fn=cmd_bench)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

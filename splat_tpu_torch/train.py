"""Scene fitting: the 3DGS optimisation loop (port of ``splat_tpu.train``).

* **Unconstrained raw parameters** (:class:`RawParams`): log scales, logit
  opacities and unnormalised quaternions, so that plain gradient steps
  never leave the valid domain; ``to_scene`` applies the loaders'
  activations, and ``pack`` packs the activated scene feature major for
  the training step's projections.
* **Loss**: mean L2 + ``l1_weight`` L1 (+ ``dssim_weight`` (1 - SSIM))
  over the views, rendered densely (exact autograd, O(N H W)) or through
  the tiled training kernels (``render/diff.py``).
* **fit()**: per-leaf Adam (``optax.scale_by_adam`` followed by a per-leaf
  learning-rate multiply, as ``splat_tpu`` composes it), the global-step
  exponential lr decay, densification with moment re-initialisation,
  the opacity reset, SH warmup and the capacity audit.

``splat_tpu`` batches the views on a leading axis and scans jitted
segments; the port loops over a list of cameras and over steps in Python.
Multi-device training (``mesh=``) runs one process per rank over
``torch.distributed``: data-parallel (views over the mesh axis "d") and
tensor-parallel (parameters, gradients and Adam moments over "g"; see
``splat_tpu_torch.parallel.sharding.render_slab_tiled_diff``).
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable

import numpy as np
import torch

from splat_tpu_torch.config import RenderConfig
from splat_tpu_torch.device import resolve_device
from splat_tpu_torch.render.dense import render_dense
from splat_tpu_torch.render.diff import render_tiled_diff
from splat_tpu_torch.render.front import packed_scene, project_front
from splat_tpu_torch.scene import DeviceScene, GaussianScene

RAW_FIELDS = ("means", "quats", "log_scales", "logit_opacities", "sh")


@dataclasses.dataclass(frozen=True)
class RawParams:
    """Unconstrained scene parameters, one float32 tensor per leaf."""

    means: torch.Tensor             # (N, 3) world centres
    quats: torch.Tensor             # (N, 4) unnormalised; ops normalise
    log_scales: torch.Tensor        # (N, 3) pre-exp
    logit_opacities: torch.Tensor   # (N,) pre-sigmoid
    sh: torch.Tensor                # (N, 16, 3)

    @classmethod
    def from_scene(cls, scene: GaussianScene,
                   eps: float = 1e-5) -> "RawParams":
        """Invert the activations.  Opacities are clamped into
        [eps, 1 - eps] first so the logit is finite."""
        op = torch.clamp(scene.opacities.detach(), eps, 1.0 - eps)
        return cls(means=scene.means.detach().clone(),
                   quats=scene.quats.detach().clone(),
                   log_scales=torch.log(torch.clamp(scene.scales.detach(),
                                                    min=1e-12)),
                   logit_opacities=torch.log(op) - torch.log1p(-op),
                   sh=scene.sh.detach().clone())

    @classmethod
    def from_numpy(cls, d: dict, device=None) -> "RawParams":
        """From a dict of arrays under the ``RAW_FIELDS`` names (e.g. the
        leaves of ``splat_tpu.train.RawParams``); device None = cuda:0."""
        device = resolve_device(device)
        return cls(**{k: torch.tensor(np.asarray(d[k], np.float32),
                                      device=device) for k in RAW_FIELDS})

    def to_numpy(self) -> dict[str, np.ndarray]:
        return {k: getattr(self, k).detach().cpu().numpy()
                for k in RAW_FIELDS}

    def to_scene(self) -> GaussianScene:
        """The activated scene (differentiable in the raw leaves)."""
        return GaussianScene(means=self.means, quats=self.quats,
                             scales=torch.exp(self.log_scales),
                             opacities=torch.sigmoid(self.logit_opacities),
                             sh=self.sh)

    def pack(self) -> DeviceScene:
        """The activated scene feature major, differentiable in the raw
        leaves: one fresh (PACKED_ROWS, N) buffer, one concatenation of
        ``to_scene()``'s activated leaves.  The training step projects its
        dense rows: a strided column view of an (N, 16, 3) leaf would be
        answered in the backward by a zero-filled gradient the size of the
        whole leaf, and the leaf's gradient by the sum of 48 of them.
        Counted in ``RawParams.pack.packs``.

        Not ``GaussianScene.pack_device``: that pack is memoized and
        refilled in place for the captured frames that replay on it; this
        one is a new autograd node at every call."""
        RawParams.pack.packs += 1
        n = self.num_gaussians
        return DeviceScene.from_buffer(torch.cat([
            self.means.T, self.quats.T, torch.exp(self.log_scales).T,
            torch.sigmoid(self.logit_opacities)[None],
            self.sh.reshape(n, 48).T]))

    @property
    def num_gaussians(self) -> int:
        return self.means.shape[0]


RawParams.pack.packs = 0


def save_raw_params(path, raw: RawParams) -> None:
    """Checkpoint the raw leaves bit-exactly (npz, the same keys as
    ``splat_tpu.train.save_raw_params``, so either package loads the
    other's checkpoints)."""
    np.savez(path, **raw.to_numpy())


def load_raw_params(path, device=None) -> RawParams:
    """Inverse of :func:`save_raw_params`; device None = cuda:0."""
    with np.load(path) as z:
        return RawParams.from_numpy({k: z[k] for k in RAW_FIELDS},
                                    device=device)


def psnr(img: torch.Tensor, ref: torch.Tensor,
         peak: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB, as a tensor."""
    mse = torch.mean((img - ref) ** 2)
    return 10.0 * torch.log10(peak * peak / torch.clamp(mse, min=1e-20))


def _gaussian_taps(window: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(window, dtype=torch.float32, device=device) - window // 2
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def _blur_conv(img: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(H, W, C) separable gaussian filter with zero padding, as two
    depthwise convolutions with cuDNN off: PyTorch's own depthwise kernel
    sums in f32, where cuDNN would take TF32 on the card."""
    c = img.shape[-1]
    r = k.shape[0] // 2
    x = img.permute(2, 0, 1)[None]
    kh = k.reshape(1, 1, 1, -1).repeat(c, 1, 1, 1)
    with torch.backends.cudnn.flags(enabled=False):
        x = torch.nn.functional.conv2d(x, kh, padding=(0, r), groups=c)
        x = torch.nn.functional.conv2d(x, kh.transpose(2, 3),
                                       padding=(r, 0), groups=c)
    return x[0].permute(1, 2, 0)


class _Blur(torch.autograd.Function):
    """The blur as its own adjoint: symmetric taps with zero padding make
    the operator symmetric, so the backward is the same blur, also run
    with cuDNN off (autograd's own conv backward would run after the
    flags are restored)."""

    @staticmethod
    def forward(ctx, img, k):
        ctx.save_for_backward(k)
        return _blur_conv(img, k)

    @staticmethod
    def backward(ctx, g):
        (k,) = ctx.saved_tensors
        return _blur_conv(g, k), None


def ssim(a: torch.Tensor, b: torch.Tensor, *, window: int = 11,
         sigma: float = 1.5, c1: float = 0.01 ** 2,
         c2: float = 0.03 ** 2) -> torch.Tensor:
    """Mean gaussian-windowed structural similarity of two (H, W, C)
    images in [0, 1] (the D-SSIM term of the 3DGS loss)."""
    k = _gaussian_taps(window, sigma, a.device)

    def blur(x):
        return _Blur.apply(x.contiguous(), k)

    mu_a, mu_b = blur(a), blur(b)
    var_a = blur(a * a) - mu_a * mu_a
    var_b = blur(b * b) - mu_b * mu_b
    cov = blur(a * b) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)
         / ((mu_a * mu_a + mu_b * mu_b + c1) * (var_a + var_b + c2)))
    return torch.mean(s)


def photometric_loss(raw: RawParams | DeviceScene, cameras, targets,
                     config: RenderConfig, l1_weight: float = 0.2,
                     chunk: int = 16, *, dssim_weight: float = 0.0,
                     method: str = "dense") -> torch.Tensor:
    """Mean over the views of L2 + ``l1_weight`` L1 (+ ``dssim_weight``
    (1 - SSIM)).  ``raw``: the parameters, or their pack
    (:meth:`RawParams.pack`; the parameters are packed once here).
    ``cameras`` is a list; ``targets`` (V, H, W, C) matches the
    renderer's channel count.  method: 'dense' or 'tiled'."""
    if method not in ("dense", "tiled"):
        raise ValueError(f"unknown method {method!r}")
    packed = raw.pack() if isinstance(raw, RawParams) else raw
    losses = []
    for camera, target in zip(cameras, targets):
        scene = _view_rows(packed)
        if method == "tiled":
            img = render_tiled_diff(scene, camera, config)
        else:
            img = render_dense(scene, camera, config, chunk=chunk)
        losses.append(_view_loss(img, target, l1_weight, dssim_weight))
    return torch.stack(losses).mean()


def _view_rows(packed: DeviceScene) -> DeviceScene:
    """One view's own row views of the pack.  A row's gradient then sums
    over the view's uses before the views' sums are added, as each view's
    column views of ``to_scene()`` sum: the two layouts give the same
    leaf gradients bit for bit (rows shared by the views would add every
    use into one sum, in another order)."""
    return DeviceScene.from_buffer(packed.buffer)


def _view_loss(img, target, l1_weight: float, dssim_weight: float):
    """One view's L2 + l1_weight L1 (+ dssim_weight (1 - SSIM))."""
    err = img - target
    loss = torch.mean(err * err) + l1_weight * torch.mean(torch.abs(err))
    if dssim_weight:
        loss = loss + dssim_weight * (1.0 - ssim(img, target))
    return loss


# Per-leaf learning-rate scale relative to the base lr.
DEFAULT_LR_SCALES = {
    "means": 0.05,
    "quats": 0.25,
    "log_scales": 1.0,
    "logit_opacities": 2.5,
    "sh": 1.0,
}


@torch.no_grad()
def _view_pairs(scene, cameras, config: RenderConfig) -> torch.Tensor:
    """(V,) int64 pair count of each view of a scene of either layout, on
    the device (no sync): one count-only projection front end a view
    (``render/front.py``).  The port's slot demand is its pair count: it
    has no sentinel slots."""
    scene = packed_scene(scene)                     # one pack, every view
    ss = config.supersample
    pairs = []
    for cam in cameras:
        if ss > 1:
            cam = cam.scaled(ss)
        pairs.append(project_front(scene, cam, config, count_only=True)[1])
    return torch.stack(pairs)


def _required_dup_factor(scene: GaussianScene, cameras,
                         config: RenderConfig) -> float:
    """max_dup_factor the views need, +5% for footprint drift."""
    n = max(scene.num_gaussians, 1)
    return int(_view_pairs(scene, cameras, config).max()) * 1.05 / n


def _check_tiled_capacity(scene: GaussianScene, cameras,
                          config: RenderConfig) -> None:
    """A truncated training forward would bias every gradient: raise
    before the first step if the capacity is short."""
    need = _required_dup_factor(scene, cameras, config)
    if config.max_dup_factor < need:
        n = max(scene.num_gaussians, 1)
        raise ValueError(
            f"fit(method='tiled'): max_dup_factor={config.max_dup_factor} "
            f"gives {int(config.max_dup_factor * n)} pair slots but the "
            f"training poses need up to {int(need * n)} (incl. 5% margin); "
            f"raise RenderConfig.max_dup_factor to at least {need:.2f}")


@dataclasses.dataclass(frozen=True)
class FitResult:
    scene: GaussianScene        # fitted scene (activated)
    raw: RawParams              # fitted raw parameters
    losses: torch.Tensor        # (steps,) loss history, losses[0] pre-step
    final_loss: float
    densify_log: tuple = ()     # per-round dicts when densification ran


def _np_quat_rotmat(q):
    """(N, 4) scalar-first quaternions -> (N, 3, 3) rotations (NumPy)."""
    q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1),
    ], axis=1)


def densify_and_prune(raw: RawParams, grad_mean, *,
                      grad_threshold: float = 5e-5,
                      split_scale_threshold: float | None = None,
                      min_opacity: float = 0.005,
                      split_factor: float = 1.6,
                      max_gaussians: int | None = None,
                      pad_multiple: int = 256,
                      seed: int = 0) -> tuple[RawParams, dict]:
    """Adaptive density control, host-side in NumPy exactly as
    ``splat_tpu.train.densify_and_prune``: clone small and split large
    splats whose mean positional-gradient norm exceeds ``grad_threshold``,
    prune those below ``min_opacity``, and pad to ``pad_multiple`` with
    dead splats.  Returns the new parameters on ``raw``'s device and the
    round's counts."""
    d = raw.to_numpy()
    g = (grad_mean.detach().cpu().numpy()
         if isinstance(grad_mean, torch.Tensor) else np.asarray(grad_mean))
    opac = 1.0 / (1.0 + np.exp(-d["logit_opacities"]))
    scales = np.exp(d["log_scales"])
    alive = opac > min_opacity
    if split_scale_threshold is None:
        live_means = d["means"][alive] if alive.any() else d["means"]
        extent = float(np.linalg.norm(
            live_means.max(0) - live_means.min(0))) if len(live_means) \
            else 1.0
        split_scale_threshold = 0.01 * max(extent, 1e-6)

    needs = alive & (g > grad_threshold)
    big = scales.max(axis=1) > split_scale_threshold
    clone_idx = np.flatnonzero(needs & ~big)
    split_idx = np.flatnonzero(needs & big)
    keep_idx = np.flatnonzero(alive & ~(needs & big))

    parts = {k: [v[keep_idx], v[clone_idx]] for k, v in d.items()}
    if len(split_idx):
        rng = np.random.default_rng(seed)
        rot = _np_quat_rotmat(d["quats"][split_idx])         # (S, 3, 3)
        for _ in range(2):
            eps = rng.normal(size=(len(split_idx), 3)).astype(np.float32)
            offset = np.einsum("nij,nj->ni", rot,
                               scales[split_idx] * eps)
            for k, v in d.items():
                if k == "means":
                    parts[k].append(v[split_idx] + offset)
                elif k == "log_scales":
                    parts[k].append(v[split_idx]
                                    - np.log(split_factor))
                else:
                    parts[k].append(v[split_idx])
    new = {k: np.concatenate(v, axis=0) for k, v in parts.items()}
    n = len(new["means"])
    if max_gaussians is not None and n > max_gaussians:
        op_new = 1.0 / (1.0 + np.exp(-new["logit_opacities"]))
        order = np.argsort(-op_new)[:max_gaussians]
        new = {k: v[order] for k, v in new.items()}
        n = max_gaussians
    n_pad = (-n) % pad_multiple
    if n_pad:
        dead = {
            "means": np.zeros((n_pad, 3), np.float32),
            "quats": np.tile(np.array([[1, 0, 0, 0]], np.float32),
                             (n_pad, 1)),
            "log_scales": np.full((n_pad, 3), -12.0, np.float32),
            "logit_opacities": np.full((n_pad,), -15.0, np.float32),
            "sh": np.zeros((n_pad, 16, 3), np.float32),
        }
        new = {k: np.concatenate([v, dead[k]], axis=0)
               for k, v in new.items()}
    stats = {"kept": len(keep_idx), "cloned": len(clone_idx),
             "split": len(split_idx), "pruned": int((~alive).sum()),
             "padded": n_pad, "n": n + n_pad}
    return RawParams.from_numpy(new, device=raw.means.device), stats


class _Adam:
    """``optax.scale_by_adam()`` (b1 0.9, b2 0.999, eps 1e-8), one state
    per leaf so that a leaf's moments can be reset alone.  The step count
    and bias corrections stay host floats (f32 arithmetic, as optax's):
    a scalar tensor copied to the card per step would synchronise it."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, raw: RawParams):
        self.state = {k: self.fresh(getattr(raw, k)) for k in RAW_FIELDS}

    @staticmethod
    def fresh(leaf: torch.Tensor):
        return [0, torch.zeros_like(leaf), torch.zeros_like(leaf)]

    def direction(self, name: str, g: torch.Tensor) -> torch.Tensor:
        st = self.state[name]
        st[0] += 1
        st[1] = (1 - self.B1) * g + self.B1 * st[1]
        st[2] = (1 - self.B2) * (g * g) + self.B2 * st[2]
        count = np.float32(st[0])
        mu_hat = st[1] / float(1 - np.float32(self.B1) ** count)
        nu_hat = st[2] / float(1 - np.float32(self.B2) ** count)
        return mu_hat / (torch.sqrt(nu_hat) + self.EPS)


class _Mesh:
    """What fit needs of a (d, g) mesh: this rank's views and the
    collectives of the data- (d) and tensor-parallel (g) axes.  Every rank
    runs fit with the same arguments and makes the same collective calls
    in the same order."""

    def __init__(self, mesh, cameras, targets, tp: bool):
        from splat_tpu_torch.parallel import sharding

        self.mesh, self.tp = mesh, tp
        self.d_group, self.n_d, d = sharding._axis(mesh, "d")
        self.g_group, self.n_g, _ = sharding._axis(mesh, "g")
        self.cameras = sharding._local_frames(cameras, mesh)
        f = len(self.cameras)
        self.targets = targets[d * f:(d + 1) * f]
        self.shard = lambda x: sharding.shard_scene(x, mesh)

    def average(self, grads: list, loss: torch.Tensor):
        """Gradients and loss averaged over 'd', in one all_reduce under
        the profiler span ``stt.fit.allreduce``; its calls and the bytes
        it reduces are counted in ``_Mesh.average.calls`` and
        ``_Mesh.average.bytes``.  The gradients are views of the reduced
        buffer, used within the step; the loss is a copy of its own, as
        fit keeps every step's loss and a view would keep the whole
        buffer alive with it."""
        flat = torch.cat([g.reshape(-1) for g in grads]
                         + [loss.detach().reshape(1)])
        _Mesh.average.calls += 1
        _Mesh.average.bytes += flat.numel() * flat.element_size()
        with torch.profiler.record_function("stt.fit.allreduce"):
            torch.distributed.all_reduce(
                flat, op=torch.distributed.ReduceOp.AVG, group=self.d_group)
        out, at = [], 0
        for g in grads:
            out.append(flat[at:at + g.numel()].view_as(g))
            at += g.numel()
        return out, flat[-1].clone()

    def demand(self, pairs: list) -> torch.Tensor:
        """The segment's peak pair demand from each step's (V_local,)
        pairs of this rank's views: summed over the shards on 'g' (TP),
        then the max over steps, views and 'd'."""
        dist = torch.distributed
        per_view = torch.stack(pairs)                     # (steps, V_local)
        if self.tp:
            dist.all_reduce(per_view, group=self.g_group)
        peak = per_view.max()
        dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=self.d_group)
        return peak

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The shards of a per-gaussian tensor over 'g', whole."""
        from splat_tpu_torch.parallel.sharding import _all_gather
        return _all_gather(x, self.g_group) if self.tp else x

    def whole(self, raw: RawParams) -> RawParams:
        return RawParams(**{k: self.gather(getattr(raw, k))
                            for k in RAW_FIELDS})


_Mesh.average.calls = 0
_Mesh.average.bytes = 0


def fit(scene: GaussianScene, cameras, targets, *, steps: int = 200,
        lr: float = 1e-2, lr_scales: dict | None = None,
        lr_decay: dict | None = None, config: RenderConfig | None = None,
        l1_weight: float = 0.2, chunk: int = 16,
        dssim_weight: float = 0.0, method: str = "dense",
        densify_every: int = 0, densify_kwargs: dict | None = None,
        opacity_reset_every: int = 0, opacity_reset_to: float = 0.01,
        sh_warmup_every: int = 0, mesh=None,
        loss_fn: Callable | None = None,
        progress_cb: Callable | None = None) -> FitResult:
    """Fit ``scene`` to ``targets`` rendered from ``cameras``.

    The arguments are those of ``splat_tpu.train.fit``, except that
    ``cameras`` is a list of cameras (``orbit_trajectory`` returns one)
    and ``targets`` a (V, H, W, C) tensor or array.  Each step sees every
    view.  ``lr_decay`` maps leaves to the factor their lr falls by over
    the run, following the global step.  ``densify_every``,
    ``opacity_reset_every`` and ``sh_warmup_every`` split the run into
    segments; between segments densification re-initialises the Adam
    moments, the opacity reset clamps opacities and resets only their
    moments, and SH warmup raises the active degree.  On the tiled path
    the pair capacity is audited before the first step, the pair demand of
    every step is tracked, and a segment whose forward was truncated, or
    came within 5% of the capacity, raises ``max_dup_factor`` (with a
    warning when pairs were dropped): never a silent truncation.
    ``progress_cb(step, loss, num_gaussians)`` runs after each segment.

    ``mesh``: a (d, g) mesh from ``parallel.make_mesh``, with every rank
    calling fit with the same whole scene, cameras and targets (ignored
    with ``loss_fn``, as in ``splat_tpu``).  The views split contiguously
    over 'd' (V divisible by its size); each rank takes the mean loss of
    its views, and gradients and the reported loss are averaged over 'd'
    (data parallel).  With ``method="tiled"`` it is also tensor parallel
    over 'g': parameters, gradients and Adam moments are sharded over 'g'
    (N divisible by its size, and densification's ``pad_multiple`` too),
    each view rendered by ``render_slab_tiled_diff``; densification
    gathers the shards, runs on every rank alike and shards the result
    again.  With one rank on 'g' its collectives are copies, and the only
    tiled fit it cannot take, supersampling, renders each rank's views
    whole as ``splat_tpu``'s data-parallel path does.  Every rank returns
    the whole fitted scene.
    """
    config = config or RenderConfig()
    scales = dict(DEFAULT_LR_SCALES)
    for name, d in (("lr_scales", lr_scales), ("lr_decay", lr_decay)):
        bad = set(d or {}) - set(scales)
        if bad:
            raise ValueError(
                f"{name} keys {sorted(bad)} are not RawParams leaves "
                f"{sorted(scales)}; a typo here would silently disable "
                f"the override")
    scales.update(lr_scales or {})
    decay = {k: 1.0 for k in scales}
    decay.update(lr_decay or {})
    if loss_fn is not None and sh_warmup_every:
        raise ValueError("sh_warmup_every needs the built-in loss "
                         "(drives config.sh_degree); drop loss_fn")
    cameras = list(cameras)
    dev = scene.device
    targets = torch.as_tensor(targets, dtype=torch.float32, device=dev)
    raw = RawParams.from_scene(scene)
    tiled = loss_fn is None and method == "tiled"

    par = None
    if mesh is not None and loss_fn is None:
        from splat_tpu_torch.parallel.sharding import _axis, _check_device
        _check_device(mesh, scene.means)
        par = _Mesh(mesh, cameras, targets, tp=tiled and (
            _axis(mesh, "g")[1] > 1 or config.supersample == 1))
    tp_g = par.n_g if par is not None and par.tp else 1

    def check_tp_divisibility(n: int) -> None:
        if tp_g > 1 and n % tp_g:
            raise ValueError(
                f"TP training shards the {n} gaussians over the mesh 'g' "
                f"axis ({tp_g}): N must be divisible (pad the scene, or set "
                f"densify pad_multiple to a multiple of {tp_g})")

    check_tp_divisibility(raw.num_gaussians)
    if tp_g > 1 and densify_every:
        pm = (densify_kwargs or {}).get("pad_multiple", 256)
        if pm % tp_g:
            raise ValueError(
                f"TP training with densification needs densify "
                f"pad_multiple ({pm}) divisible by the 'g' axis ({tp_g}) so "
                f"every topology keeps N % g == 0")

    def loss_for_degree(deg: int):
        """The step's loss: of the RawParams for ``loss_fn``, else of
        their pack (this rank's shard of it on the TP path)."""
        if loss_fn is not None:
            return loss_fn
        cfg = dataclasses.replace(config, sh_degree=deg)
        if par is None:
            return lambda p: photometric_loss(p, cameras, targets, cfg,
                                              l1_weight, chunk,
                                              dssim_weight=dssim_weight,
                                              method=method)
        if not par.tp:
            return lambda p: photometric_loss(p, par.cameras, par.targets,
                                              cfg, l1_weight, chunk,
                                              dssim_weight=dssim_weight,
                                              method=method)
        from splat_tpu_torch.parallel.sharding import render_slab_tiled_diff

        def tp_loss(p):
            return torch.stack([
                _view_loss(render_slab_tiled_diff(_view_rows(p), c, cfg,
                                                  par.mesh),
                           t, l1_weight, dssim_weight)
                for c, t in zip(par.cameras, par.targets)]).mean()
        return tp_loss

    if tiled:
        _check_tiled_capacity(scene, cameras, config)
    if par is not None and par.tp:
        raw = par.shard(raw)
    n_total = raw.num_gaussians * tp_g

    bounds: set[int] = set()
    for k in (densify_every, opacity_reset_every):
        if k and k > 0:
            bounds.update(range(k, steps, k))
    if sh_warmup_every and sh_warmup_every > 0:
        bounds.update(range(sh_warmup_every,
                            min(config.sh_degree * sh_warmup_every + 1,
                                steps), sh_warmup_every))
    edges = [0] + sorted(bounds) + [steps]

    def degree_at(step: int) -> int:
        if not sh_warmup_every:
            return config.sh_degree
        return min(config.sh_degree, step // sh_warmup_every)

    def lr_at(name: str, gstep: int) -> float:
        """The signed step size, in f32 as splat_tpu computes it."""
        frac = np.float32(gstep) / np.float32(max(steps - 1, 1))
        rate = np.exp(frac * np.float32(math.log(decay[name])))
        return float(np.float32(-lr * scales[name]) * rate)

    def capacity_margin_check(dmax: int, n: int) -> None:
        nonlocal config
        k_cap = int(config.max_dup_factor * n)
        if dmax > k_cap:
            new_dup = math.ceil(dmax * 1.05 / n * 20) / 20
            warnings.warn(
                f"fit: splat footprints grew past the capacity margin "
                f"mid-segment (peak demand {dmax} pairs > k_cap {k_cap}); "
                f"that segment's gradients were computed on a truncated "
                f"forward; raising max_dup_factor to {new_dup} for the "
                f"remaining steps", stacklevel=3)
        elif dmax * 1.05 > k_cap:
            new_dup = math.ceil(dmax * 1.10 / n * 20) / 20
        else:
            return
        config = dataclasses.replace(config, max_dup_factor=new_dup)

    adam = _Adam(raw)
    all_losses: list[torch.Tensor] = []
    densify_log = []
    gsum_acc, gsteps = None, 0
    demand_cams = par.cameras if par is not None else cameras
    for b0, b1 in zip(edges[:-1], edges[1:]):
        seg_loss = loss_for_degree(degree_at(b0))
        gsum = torch.zeros(raw.num_gaussians, dtype=torch.float32, device=dev)
        pairs = []
        for gstep in range(b0, b1):
            leaves = {k: getattr(raw, k).detach().requires_grad_(True)
                      for k in RAW_FIELDS}
            cur = RawParams(**leaves)
            if loss_fn is None:
                packed = cur.pack()
                loss = seg_loss(packed)
            else:
                loss = seg_loss(cur)
            loss.backward()
            if tiled:
                # demand of the state the gradient was computed at
                pairs.append(_view_pairs(packed, demand_cams, config))
            grads = [leaves[k].grad if leaves[k].grad is not None
                     else torch.zeros_like(leaves[k]) for k in RAW_FIELDS]
            if par is not None:
                grads, loss = par.average(grads, loss)
            new = {}
            for k, g in zip(RAW_FIELDS, grads):
                if k == "means":
                    gsum = gsum + torch.linalg.vector_norm(g, dim=1)
                new[k] = (leaves[k].detach()
                          + adam.direction(k, g) * lr_at(k, gstep))
            raw = RawParams(**new)
            all_losses.append(loss.detach())
        gsum_acc = gsum if gsum_acc is None else gsum_acc + gsum
        gsteps += b1 - b0
        if progress_cb is not None:
            progress_cb(b1, float(all_losses[-1]), n_total)
        if tiled:
            dmax = (par.demand(pairs) if par is not None
                    else torch.stack(pairs).max())
            capacity_margin_check(int(dmax), n_total)
        if b1 == steps:
            break
        if densify_every and b1 % densify_every == 0:
            whole = par.whole(raw) if par is not None else raw
            grad_mean = gsum_acc / gsteps
            if par is not None:
                grad_mean = par.gather(grad_mean)
            whole, stats = densify_and_prune(whole, grad_mean,
                                             **(densify_kwargs or {}))
            densify_log.append(stats)
            check_tp_divisibility(whole.num_gaussians)
            raw = par.shard(whole) if par is not None and par.tp else whole
            n_total = whole.num_gaussians
            adam = _Adam(raw)           # topology changed
            gsum_acc, gsteps = None, 0
            if tiled:
                # pruning shrinks k_cap while the survivors keep their
                # footprints: re-audit and raise instead of truncating
                need = _required_dup_factor(whole.to_scene(), cameras,
                                            config)
                if config.max_dup_factor < need:
                    new_dup = math.ceil(need * 20) / 20
                    warnings.warn(
                        f"fit: densification left max_dup_factor="
                        f"{config.max_dup_factor} below the measured pair "
                        f"demand ({need:.2f}); raising it to {new_dup}",
                        stacklevel=2)
                    config = dataclasses.replace(config,
                                                 max_dup_factor=new_dup)
        if opacity_reset_every and b1 % opacity_reset_every == 0:
            # clamp every opacity down; only the opacity moments reset
            cap = math.log(opacity_reset_to / (1.0 - opacity_reset_to))
            raw = dataclasses.replace(raw, logit_opacities=torch.clamp(
                raw.logit_opacities, max=float(np.float32(cap))))
            adam.state["logit_opacities"] = _Adam.fresh(raw.logit_opacities)

    if par is not None:
        raw = par.whole(raw)
    losses = torch.stack(all_losses)
    return FitResult(scene=raw.to_scene(), raw=raw, losses=losses,
                     final_loss=float(losses[-1]),
                     densify_log=tuple(densify_log))

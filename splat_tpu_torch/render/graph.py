"""The compiled frame: the port's ``jax.jit``, as captured CUDA graphs.

``splat_tpu`` compiles its frame once per configuration and shape
(``render_fn`` returns ``jax.jit(f)``) and then calls the compiled program
with a new camera pose each frame.  PyTorch runs eagerly: one tiled frame
is some six hundred launches sent from Python (the projection's
elementwise kernels, the binning with K1, the compositing with K2), and
the card idled half of each 1M frame @1080p waiting for them (PERF.md
section 5).  Here a frame is captured once into a ``torch.cuda.CUDAGraph``
and then replayed: one launch from the host a frame.

:func:`compiled` wraps ``fn(scene, camera)`` as ``jax.jit`` wraps a
function.  On CUDA tensors each key

    (tag, N, H, W, camera kind and field shapes, device, scene tensors)

is captured once by :func:`capture` and then replayed:

- the capture first calls ``fn`` once eagerly on the capture stream (the
  first call builds the kernels' library; CUB and cuBLAS take their
  workspaces), then records a second call;
- a replay copies the camera's tensors into the graph's static camera, so
  the pose is the one per-frame input;
- the graph reads the scene where it lay at capture and keeps a strong
  reference to its tensors, so their memory is never handed to another
  tensor under it: an in-place edit of them is read by the next replay,
  and a scene in other memory (another pack, another buffer) is another
  key;
- outputs are cloned on return, as JAX returns a fresh array each call.

The cached graphs share one memory pool a device (a fresh one after a
capture that failed, which PyTorch leaves unusable): a later capture may
reuse memory an earlier one freed, so one graph's replay may overwrite
another's static outputs.  Replays run one at a time under a lock and each
clones its outputs before the next, which makes the sharing safe.  At most
CACHE_SIZE graphs are kept, the least recently used going first.

CPU tensors capture nothing: the wrapped function is called as it is, the
path of the CPU tests, as the kernel wrappers take their plain versions
there.  On the card a capture that fails raises; nothing falls back to the
eager frame.  A frame whose scene or camera requires grad, under grad
mode, runs eagerly: a graph's outputs carry no autograd history.

Launch counters: the kernel wrappers count in Python where they launch,
which a replay does not run.  Each wrapper registers its counters here
(:func:`count_replays`); a capture records what they gained while it
recorded, takes that back (recording launches nothing), and each replay
adds it and re-points the wrapper's last-launch attributes (K2's
``split_tiles`` / ``tile_order``) at the replayed graph's tensors.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time

import torch

# captured frames kept, least recently used first out
CACHE_SIZE = 8

# (wrapper, its counter attributes, its last-launch attributes), one entry
# a kernel wrapper (count_replays)
_COUNTED: list = []

_LOCK = threading.RLock()
_POOLS: dict = {}
_STREAMS: dict = {}
# graphs captured and replays run in this process
counts = {"captures": 0, "replays": 0}


def count_replays(fn, counters, last=()) -> None:
    """Register kernel wrapper ``fn``'s launch counters (the attributes of
    ``fn`` that its launches add to) and ``last``, the attributes it points
    at its last launch's tensors: a replay of a graph that holds the
    kernel adds what its capture counted and re-points ``last`` at the
    graph's tensors."""
    _COUNTED.append((fn, tuple(counters), tuple(last)))


def scene_tensors(scene) -> tuple:
    """The tensors a frame reads from ``scene``: a packed scene's buffer,
    else every tensor field."""
    buf = scene.__dict__.get("_buffer")          # DeviceScene.from_buffer
    if buf is not None:
        return (buf,)
    out = []
    for f in dataclasses.fields(scene):
        v = getattr(scene, f.name)
        out.extend(v if isinstance(v, tuple) else (v,))
    return tuple(out)


def _pose_fields(camera) -> tuple:
    return tuple(f.name for f in dataclasses.fields(camera)
                 if f.name not in ("h", "w"))


def _where(tensors) -> tuple:
    return tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                 for t in tensors)


def frame_key(tag, scene, camera) -> tuple:
    """The cache key of ``fn`` (named by ``tag``) on this scene and
    camera: what a captured graph bakes in.  The pose's values are not in
    it; the scene's memory is."""
    cam = (type(camera).__name__, camera.h, camera.w,
           tuple((n, tuple(getattr(camera, n).shape))
                 for n in _pose_fields(camera)))
    return (tag, scene.num_gaussians, cam, str(scene.device),
            _where(scene_tensors(scene)))


def _needs_autograd(scene, camera) -> bool:
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in scene_tensors(scene)
        + tuple(getattr(camera, n) for n in _pose_fields(camera)))


def _pool(dev):
    if dev not in _POOLS:
        _POOLS[dev] = torch.cuda.graph_pool_handle()
    return _POOLS[dev]


def _stream(dev) -> torch.cuda.Stream:
    if dev not in _STREAMS:
        _STREAMS[dev] = torch.cuda.Stream(device=dev)
    return _STREAMS[dev]


def _recover(dev, pool, stream) -> None:
    """Undo what a failed capture leaves behind: ``torch.cuda.graph``
    raises from its capture's end before it restores the caller's stream
    and before the allocator stops routing allocations to the pool.
    Restore the stream, end the routing, and retire the pool from the
    cache: PyTorch refuses any later capture into it (graphs captured in
    it before still replay)."""
    torch.cuda.set_stream(stream)
    try:
        torch._C._cuda_endAllocateToPool(dev.index, pool)
    except RuntimeError:
        pass                    # the capture had ended its routing
    if _POOLS.get(dev) == pool:
        del _POOLS[dev]


def _clone(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, dict):
        return {k: _clone(v) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(_clone(v) for v in out)
    return out


class FrameCache:
    """At most ``size`` entries, the least recently used going first."""

    def __init__(self, size: int):
        self.size = size
        self._d: collections.OrderedDict = collections.OrderedDict()

    def get(self, key, make):
        """The entry of ``key``, made by ``make()`` on a miss."""
        hit = self._d.get(key)
        if hit is None:
            hit = self._d[key] = make()
            while len(self._d) > self.size:
                self._d.popitem(last=False)
        else:
            self._d.move_to_end(key)
        return hit

    def peek(self, key):
        """The entry of ``key`` or None, leaving the order as it is."""
        return self._d.get(key)

    def __contains__(self, key) -> bool:
        return key in self._d

    def __len__(self) -> int:
        return len(self._d)

    def clear(self) -> None:
        self._d.clear()


_CACHE = FrameCache(CACHE_SIZE)


class CapturedFrame:
    """One captured call of ``fn(scene, camera)``; calling it with the
    scene it was captured on and a camera of the same kind and shapes
    replays it.

    capture_s: seconds to record and instantiate the graph (the eager
      warm-up call before it not included).
    pool_bytes: what the device's reserved memory grew by during the
      capture: the graph's share of its pool.
    """

    def __init__(self, graph, where, scene, camera, out, gained, last,
                 capture_s, pool_bytes):
        self.graph = graph
        self._where = where
        self._scene = scene_tensors(scene)        # keeps the memory alive
        self._fields = tuple((n, getattr(camera, n))
                             for n in _pose_fields(camera))
        self._out = out
        self._gained = gained
        self._last = last
        self.device = scene.device
        self.capture_s = capture_s
        self.pool_bytes = pool_bytes

    def __call__(self, scene, camera):
        if _where(scene_tensors(scene)) != self._where:
            raise ValueError("a captured frame replays on the scene memory "
                             "it was captured on")
        with _LOCK, torch.cuda.device(self.device), torch.no_grad():
            for name, t in self._fields:
                t.copy_(getattr(camera, name))
            self.graph.replay()
            for fn, attr, n in self._gained:
                setattr(fn, attr, getattr(fn, attr) + n)
            for fn, attr, t in self._last:
                setattr(fn, attr, t)
            counts["replays"] += 1
            return _clone(self._out)


def capture(fn, scene, camera, *, pool=None) -> CapturedFrame:
    """Capture ``fn(scene, camera)`` on the scene's card (a CUDA device)
    into a graph, after one eager warm-up call on the capture stream.
    pool: the graph memory pool to capture into (None: a new one).  The
    capture refuses what this thread does that a graph cannot hold, not
    what other threads (a server's handlers) do beside it.  A capture
    that fails raises."""
    dev = scene.device
    if dev.type != "cuda":
        raise ValueError(f"capture: a CUDA graph needs a CUDA device, got "
                         f"{dev}")
    with _LOCK, torch.cuda.device(dev), torch.no_grad():
        with torch.inference_mode(False):
            static = dataclasses.replace(camera, **{
                n: getattr(camera, n).detach().to(dev, copy=True)
                for n in _pose_fields(camera)})
        stream = _stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            fn(scene, static)
        counters = [(f, a) for f, attrs, _ in _COUNTED for a in attrs]
        lasts = [(f, a) for f, _, attrs in _COUNTED for a in attrs]
        before = [getattr(f, a) for f, a in counters]
        last_before = [getattr(f, a) for f, a in lasts]
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        if pool is None:
            pool = torch.cuda.graph_pool_handle()
        caller = torch.cuda.current_stream(dev)
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                out = fn(scene, static)
            capture_s = time.perf_counter() - t0
            gained = [(f, a, getattr(f, a) - b)
                      for (f, a), b in zip(counters, before)
                      if getattr(f, a) != b]
            launched = {f for f, _, _ in gained}
            last = [(f, a, getattr(f, a)) for f, a in lasts
                    if f in launched]
        except BaseException:
            _recover(dev, pool, caller)
            raise
        finally:
            # recording launched nothing: take back what it counted
            for (f, a), b in zip(counters + lasts, before + last_before):
                setattr(f, a, b)
        counts["captures"] += 1
        return CapturedFrame(graph, _where(scene_tensors(scene)), scene,
                             static, out, gained, last, capture_s,
                             torch.cuda.memory_reserved(dev) - reserved)


def compiled(fn, tag):
    """``fn(scene, camera)`` compiled as ``jax.jit`` compiles a function:
    on the card each key (:func:`frame_key`) is captured once into the
    shared cache and replayed; CPU tensors call ``fn``.  ``tag`` is a
    hashable name of ``fn``: two functions under one tag must compute the
    same thing."""
    def f(scene, camera):
        dev = scene.device
        if dev.type == "cpu" or _needs_autograd(scene, camera):
            return fn(scene, camera)
        if dev.type != "cuda":
            raise ValueError(f"compiled frame: unsupported device {dev}")
        with _LOCK:
            hit = _CACHE.get(frame_key(tag, scene, camera), lambda: capture(
                fn, scene, camera, pool=_pool(dev)))
            return hit(scene, camera)

    return f


def captured(tag, scene, camera) -> CapturedFrame | None:
    """The cached capture of ``tag`` (as given to :func:`compiled`) on
    this scene and camera, if there is one (its capture time and pool
    share)."""
    return _CACHE.peek(frame_key(tag, scene, camera))


def clear() -> None:
    """Drop every cached graph (their memory returns to the pool)."""
    with _LOCK:
        _CACHE.clear()

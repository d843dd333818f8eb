"""Reading a ``torch.profiler`` trace of a traced slice of the window.

The slice runs inside :func:`traced`, which wraps it in the span
``splatbench.window`` between two device synchronisations.  The trace's
device events (kernels, copies, fills) give the busy time as the union of
their intervals inside the span, time by kernel name, and the idle gaps
between them, each labelled with the innermost host event that was open
at the gap's middle.  Kernels are sorted into the layers the per-layer
metrics read by the names the program gives them (:data:`KERNELS`);
the work-list kernel that each raster kernel launches before itself
counts with that raster kernel.

The profiler lengthens the wall time of what it traces, so the shares
that divide by a frame's or a step's time (``idle_share.*``, ``*mfu``)
take it from an untraced run of the same work (``Run.unit_s``); the
slice gives the device intervals.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile

import torch

WINDOW_SPAN = "splatbench.window"
# layer -> substrings of the program's kernel names
KERNELS = {
    "k1": ("expand_pairs_kernel",),
    "k2": ("raster_kernel",),
    "k3": ("train_fwd_kernel",),
    "k4": ("train_bwd_kernel",),
}
PLAN_KERNEL = "raster_plan_kernel"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
NAME_CHARS = 100
TOP = 10
BIN_US = 200.0


@contextlib.contextmanager
def traced(out: dict):
    """Profile the body on the host and, where there is one, the card; on
    exit ``out`` holds the parsed trace events (``events``)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    sync()
    with profile(activities=activities) as prof:
        with record_function(WINDOW_SPAN):
            sync()
            yield
            sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            out["events"] = json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def layer_of(name: str) -> str:
    low = name.lower()
    for layer, keys in KERNELS.items():
        if any(k.lower() in low for k in keys):
            return layer
    return "other"


def summarize(events: list, units: int) -> dict:
    """The slice's numbers, for ``units`` frames or steps: window and busy
    seconds, seconds by layer (k1..k4, other), the top device
    operations by name and the idle time by what the host was doing."""
    span = next(e for e in events if e.get("ph") == "X"
                and e.get("name") == WINDOW_SPAN
                and e.get("cat") == "user_annotation")
    t0, t1 = float(span["ts"]), float(span["ts"]) + float(span["dur"])
    dev = sorted((e for e in events if e.get("ph") == "X"
                  and e.get("cat") in DEVICE_CATS
                  and t0 <= float(e["ts"]) < t1),
                 key=lambda e: float(e["ts"]))
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in HOST_CATS and e.get("name") != WINDOW_SPAN]

    layers = dict.fromkeys([*KERNELS, "other"], 0.0)
    by_name: dict[str, float] = {}
    plan = 0.0
    for e in dev:
        dur = float(e["dur"]) * 1e-6
        name = e.get("name", "")[:NAME_CHARS]
        by_name[name] = by_name.get(name, 0.0) + dur
        if PLAN_KERNEL in name:
            plan += dur             # counts with the next raster kernel
            continue
        layer = layer_of(name)
        if layer in ("k2", "k3", "k4"):
            layers[layer] += dur + plan
            plan = 0.0
        else:
            layers[layer] += dur
    layers["other"] += plan

    # busy time: the union of the device intervals inside the span
    busy, gaps, end = 0.0, [], t0
    for e in dev:
        s = float(e["ts"])
        f = min(s + float(e["dur"]), t1)
        if s > end:
            gaps.append((end, s))
        if f > end:
            busy += f - max(s, end)
            end = f
    if t1 > end:
        gaps.append((end, t1))
    # host events by the 200 us bins they cover, so a gap finds its own
    bins: dict[int, list] = {}
    for e in host:
        s, f = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if f < t0 or s > t1:
            continue
        for k in range(int((max(s, t0) - t0) // BIN_US),
                       int((min(f, t1) - t0) // BIN_US) + 1):
            bins.setdefault(k, []).append(e)
    idle: dict[str, float] = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        inner = [e for e in bins.get(int((mid - t0) // BIN_US), ())
                 if float(e["ts"]) <= mid <= float(e["ts"]) + float(e["dur"])]
        label = (min(inner, key=lambda e: float(e["dur"]))["name"]
                 [:NAME_CHARS] if inner else "(no host event)")
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-6
    rank = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps_rank = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {"window_s": (t1 - t0) * 1e-6, "busy_s": busy * 1e-6,
            "units": units, "layers_s": layers,
            "device_ops": [[k, v] for k, v in rank],
            "idle_gaps": [[k, v] for k, v in gaps_rank]}


def busy_per_unit(run):
    """Device seconds a frame or step in the traced slice (the union of
    its device intervals over its frames or steps); None untraced."""
    if not run.trace or not run.unit_s:
        return None
    return run.trace["busy_s"] / run.trace["units"]


def idle_share(run):
    """100 x (1 - device-busy seconds a frame or step in the traced slice
    / host seconds a frame or step of the same work untraced).  The
    traced slice's own wall time is not the denominator: the profiler
    lengthens it (a graph launch costs more traced), but not the device
    intervals.  None untraced."""
    busy = busy_per_unit(run)
    return None if busy is None else 100.0 * (1.0 - busy / run.unit_s)


def layer_ms(run, layer: str):
    """Device ms of a layer's kernels per frame or step; None untraced."""
    if not run.trace:
        return None
    return run.trace["layers_s"][layer] / run.trace["units"] * 1e3

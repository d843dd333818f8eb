"""What the benchmark finds by name, and what a run reports.

``BENCHMARK.json`` at the root of the checkout names the cells; each
cell's configuration, traffic mix and limits, and each metric's reader,
are files of their own that :class:`Bench` finds by name:

* ``splatbench/configs/<config>.json``: the scene, the camera, the tiles;
* ``splatbench/traffic/<traffic>.json``: the mix's parameters, read by
  the runner of its ``kind``;
* ``splatbench/runners/<kind>.py``: ``run(cell)`` and ``readings(cell,
  outcome, control)`` of a traffic kind (``drive.py``);
* ``splatbench/limits/<workload>.json``: the limit of each number the
  correctness check compares, with the readings it was set from;
* ``splatbench/metrics/<metric>.py``: ``read(run)``, the metric's value
  from a :class:`Run`, or None where the run holds nothing to read.

So a configuration, a mix, a traffic kind or a metric is added as files
and manifest entries, without an edit to a file that is there.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
# top-level modules the process that prints the result may not hold
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "splat_tpu")


class Bench:
    """The manifest and the files it names, under ``root``."""

    def __init__(self, root=None):
        self.root = pathlib.Path(root) if root else HERE.parent
        self.dir = self.root / "splatbench"
        self.manifest = json.loads((self.root / "BENCHMARK.json").read_text())

    def _json(self, sub: str, name: str) -> dict:
        path = self.dir / sub / f"{name}.json"
        if not path.is_file():
            raise FileNotFoundError(f"no file {path}")
        return json.loads(path.read_text())

    def workload(self, name: str) -> dict:
        for w in self.manifest["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def limits(self, workload: str) -> dict:
        return self._json("limits", workload)

    def metrics(self, workload: str, traced: bool) -> list:
        """The manifest's metrics a run of ``workload`` reports: the
        end-to-end ones untraced, the per-layer ones traced."""
        group = self.manifest["per_layer" if traced else "end_to_end"]
        return [m for m in group
                if workload in m.get("workloads", [workload])]

    def _module(self, sub: str, name: str):
        path = self.dir / sub / f"{name}.py"
        if not path.is_file():
            raise FileNotFoundError(f"no file {path}")
        spec = importlib.util.spec_from_file_location(
            f"splatbench_{sub}_" + name.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def reader(self, metric: str):
        """``read`` of ``metrics/<metric>.py``."""
        return self._module("metrics", metric).read

    def runner(self, kind: str):
        """The module ``runners/<kind>.py``: its ``run`` and
        ``readings``."""
        return self._module("runners", kind)


@dataclasses.dataclass
class Run:
    """What one run measured, for the metric readers.

    setup_s: process start to the window, host clock.
    window_s, frames, steps, latencies_s: the window, host clock; with
      ``--trace 1`` the traced slice's window and every frame or step.
    trace: with ``--trace 1``, the ``trace.summarize`` dict of the slice.
    unit_s: with ``--trace 1``, host-clock seconds a frame or step of an
      untraced run of the traced slice's work (the profiler not on).
    frame_work: work dicts of the checked frames (reference counts).
    view_work: work dicts of the views' first training forward.
    pixels: pixels of a frame; params: float32 parameters of the scene.
    """

    setup_s: float = 0.0
    window_s: float = 0.0
    frames: int = 0
    steps: int = 0
    latencies_s: list = dataclasses.field(default_factory=list)
    trace: dict | None = None
    unit_s: float | None = None
    frame_work: list | None = None
    view_work: list | None = None
    pixels: int = 0
    params: int = 0


def read_metrics(bench: Bench, workload: str, traced: bool, run: Run) -> dict:
    """{name: {"value", "unit"}} of every metric the cell reports that
    its reader finds something for."""
    out = {}
    for m in bench.metrics(workload, traced):
        value = bench.reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_loaded() -> list:
    """Top-level names in ``sys.modules`` the result's process may not
    hold, compared whole."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def power_limit(index: int) -> str | None:
    """The card's power limit as ``nvidia-smi`` reads it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def checks_text(checks: dict) -> list:
    """One line per compared number, beside its limit."""
    return [f"check {k}: {v['value']!r} limit {v['limit']!r}"
            for k, v in checks.items()]

"""Small cells for the CPU tests: the manifest's cells with their scene
and image shrunk, run on the CPU through the same runners."""

import copy
import pathlib
import time

import torch

from splatbench import drive, harness

BENCH = harness.Bench()
# more than 4096 gaussians: render() takes the tiled path, as at full size
SMALL = {"n": 5000, "h": 64, "w": 96}


def small_cell(workload: str, seconds: float = 0.5, seed: int = 2**31 + 5,
               **traffic) -> drive.Cell:
    """``workload`` shrunk to SMALL, with ``traffic`` keys overridden."""
    w = BENCH.workload(workload)
    cfg = copy.deepcopy(BENCH.config(w["config"]))
    cfg["scene"]["n"] = SMALL["n"]
    cfg["camera"].update(h=SMALL["h"], w=SMALL["w"])
    tr = dict(BENCH.traffic(w["traffic"]), warm_stride=250,
              warm_frames=1, settle_s=0, trace_frames=2, untraced_passes=2,
              check_frames=2, check_steps=2, timing_steps=1, trace_steps=2)
    tr.update(traffic)
    return drive.Cell(workload=workload, config=cfg, traffic=tr,
                      limits=BENCH.limits(workload), seed=seed,
                      seconds=seconds, traced=False,
                      device=torch.device("cpu"),
                      t_start=time.perf_counter())


def run(cell: drive.Cell) -> drive.Outcome:
    """The cell's run through the runner of its traffic kind."""
    return BENCH.runner(cell.traffic["kind"]).run(cell)


def need_cuda():
    import pytest

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


HERE_TESTS = pathlib.Path(__file__).resolve().parent

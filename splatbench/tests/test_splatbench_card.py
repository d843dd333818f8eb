"""On the card (marked ``cuda``, skipped without one): a cell's run
prints its result line, and the control fails the cell's limits at
the cell's own size.  ``python -m pytest splatbench/tests -m cuda``."""

import json
import pathlib
import subprocess
import sys

import pytest
import torch

from splatbench import check, drive

from helpers import BENCH, need_cuda

ROOT = pathlib.Path(__file__).resolve().parents[2]
ONE_CHIP = [w["name"] for w in BENCH.manifest["workloads"]
            if w["chips"] == 1]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ONE_CHIP)
def test_run_prints_the_result_line(workload):
    need_cuda()
    res = subprocess.run(
        [sys.executable, "splatbench/run.py", "--workload", workload,
         "--seed", str(2**31 + 3), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["device"]["platform"] == "gpu"
    names = {m["name"] for m in BENCH.metrics(workload, False)}
    assert set(line["metrics"]) == names


def _cell(workload):
    import time

    w = BENCH.workload(workload)
    return drive.Cell(workload=workload, config=BENCH.config(w["config"]),
                      traffic=BENCH.traffic(w["traffic"]),
                      limits=BENCH.limits(workload), seed=2**31 + 4,
                      seconds=1.0, traced=False,
                      device=torch.device("cuda", 0),
                      t_start=time.perf_counter())


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ONE_CHIP)
def test_control_fails_at_cell_size(workload):
    need_cuda()
    cell = _cell(workload)
    runner = BENCH.runner(cell.traffic["kind"])
    rows = runner.readings(cell, runner.run(cell), True)
    limits = cell.limits["limits"]
    verdicts = {r["kind"]: check.judge(
        {k: r[k] for k in limits}, limits)[0] for r in rows}
    assert verdicts.pop("sound")
    assert not any(verdicts.values()), verdicts

"""The ``fit_dp`` kind at a small size on a CPU world of gloo ranks, with a
fault put underneath in every rank (for ``test_splatbench_fit_dp.py``).

    python dp_ranks.py --lead OUT.json --fault NAME [--seconds S]
        [--traced] [--readings] [--marker FILE]

runs ``surface-3m-fit-dp4`` shrunk to 2,000 gaussians at 64 x 64 (the
CPU twins of K3 and K4 take seconds a step there) as rank 0, through the
cell's runner, which starts ranks 1.. as this file again (``--fault
NAME`` and the rank's arguments), and writes what the run gave to
OUT.json.  Faults: ``none``; ``exchange_left_out`` (each
rank steps on its own views' gradients); ``quarter_views`` (every rank
given rank 0's views); ``kill_rank`` (rank 2 killed a second into the
window); ``raise_rank0`` (rank 0 raising a second into the window).  The
last two touch ``--marker`` when they strike.
"""

import argparse
import copy
import json
import os
import pathlib
import signal
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import splat_tpu_torch as stt  # noqa: E402
from splat_tpu_torch import train  # noqa: E402
from splatbench import check, drive, harness  # noqa: E402

WORKLOAD = "surface-3m-fit-dp4"
SIZE = {"n": 2000, "h": 64, "w": 64}
BENCH = harness.Bench(ROOT)
RUNNER = BENCH.runner("fit_dp")
CHECK_STEPS = 2


def small_cell(seconds: float, traced: bool) -> drive.Cell:
    w = BENCH.workload(WORKLOAD)
    cfg = copy.deepcopy(BENCH.config(w["config"]))
    cfg["scene"]["n"] = SIZE["n"]
    cfg["camera"].update(h=SIZE["h"], w=SIZE["w"])
    tr = dict(BENCH.traffic(w["traffic"]), check_steps=CHECK_STEPS,
              timing_steps=1, trace_steps=2)
    return drive.Cell(workload=WORKLOAD, config=cfg, traffic=tr,
                      limits=BENCH.limits(WORKLOAD), seed=2**31 + 11,
                      seconds=seconds, traced=traced,
                      device=torch.device("cpu"),
                      t_start=time.perf_counter())


def _strike(marker: str, act) -> None:
    pathlib.Path(marker).touch()
    act()


def break_program(fault: str, rank: int, marker: str) -> None:
    """Put ``fault`` underneath this rank's program."""
    real = stt.fit
    if fault == "exchange_left_out":
        train._Mesh.average = lambda self, grads, loss: (
            grads, loss.detach().clone())
    elif fault == "quarter_views":
        def fit(scene, cameras, targets, **kw):
            per = len(cameras) // 4
            return real(scene, cameras[:per] * 4,
                        targets[:per].repeat(4, 1, 1, 1), **kw)
        stt.fit = fit
    elif (fault, rank) in (("kill_rank", 2), ("raise_rank0", 0)):
        def fit(scene, cameras, targets, *, steps, **kw):
            if steps > CHECK_STEPS:             # the window's call
                if fault == "kill_rank":
                    threading.Timer(1.0, _strike, (marker, lambda: os.kill(
                        os.getpid(), signal.SIGKILL))).start()
                else:
                    time.sleep(1.0)
                    pathlib.Path(marker).touch()
                    raise RuntimeError("rank 0 fails on purpose")
            return real(scene, cameras, targets, steps=steps, **kw)
        stt.fit = fit


def lead(args) -> int:
    RUNNER.RANK_COMMAND = [sys.executable, __file__, "--fault", args.fault,
                           "--marker", args.marker]
    break_program(args.fault, 0, args.marker)
    cell = small_cell(args.seconds, args.traced)
    out = RUNNER.run(cell)
    limits = cell.limits["limits"]
    ok, _ = check.judge(out.numbers, limits)
    got = {"correct": bool(ok and out.failed == 0), "numbers": out.numbers,
           "steps": out.run.steps, "failed": out.failed,
           "metrics": harness.read_metrics(BENCH, WORKLOAD, args.traced,
                                           out.run),
           "n": SIZE["n"]}
    if out.run.trace:
        got["trace"] = {k: out.run.trace.get(k) for k in (
            "units", "nccl_s", "allreduce_bytes", "allreduce_calls",
            "ranks")}
    if args.readings:
        got["readings"] = {
            r["kind"]: check.judge({k: r[k] for k in limits}, limits)[0]
            for r in RUNNER.readings(cell, out, True)}
    with open(args.lead, "w") as f:
        json.dump(got, f)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fault", default="none")
    ap.add_argument("--marker", default=os.devnull)
    ap.add_argument("--lead")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--traced", action="store_true")
    ap.add_argument("--readings", action="store_true")
    args, rest = ap.parse_known_args()
    if args.lead:
        return lead(args)
    rank = int(rest[rest.index("--rank") + 1])
    break_program(args.fault, rank, args.marker)
    return RUNNER.rank_main(rest)


if __name__ == "__main__":
    sys.exit(main())

"""Readings that the correctness check's limits are set from, at a
cell's own size (run on the card; see PERF.md).

    python3 splatbench/calibrate.py --workload <name> --seeds 12 \\
        --control-seeds 3 [--seconds 2] [--first-seed N]

For each of ``--seeds`` seeds it runs the cell's runner with a short
window (``--seconds``) and prints the numbers the check compared: the
sound program's readings.  For the first ``--control-seeds`` of them it
also prints the runner's ``readings`` with the control in the program's
place, the reference computed with its per-pair features in bfloat16,
and for a training cell the faults a run can have: half of the views
left out (the mean taken over the rest) and a state left unchanged.
One JSON line a reading on standard output.
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=4_100_000_000)
    args = ap.parse_args(argv)

    import torch

    from splatbench import drive, harness

    bench = harness.Bench(ROOT)
    w = bench.workload(args.workload)
    config, traffic = bench.config(w["config"]), bench.traffic(w["traffic"])
    runner = bench.runner(traffic["kind"])
    dev = torch.device("cuda", 0)
    for i in range(args.seeds):
        cell = drive.Cell(workload=args.workload, config=config,
                          traffic=traffic, limits=bench.limits(args.workload),
                          seed=args.first_seed + 7919 * i,
                          seconds=args.seconds, traced=False, device=dev,
                          t_start=time.perf_counter())
        out = runner.run(cell)
        for row in runner.readings(cell, out, i < args.control_seeds):
            print(json.dumps(dict(workload=args.workload, **row)), flush=True)
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

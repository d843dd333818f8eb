"""Run one cell of the benchmark of ``splat_tpu_torch`` once.

    python3 splatbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``) names a
configuration, a traffic mix and a number of cards; the runner of the
mix's kind (``runners/<kind>.py``) drives it on card 0.  The run
prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the end-to-end ones,
or with ``--trace 1`` the per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the correctness check compared, beside its
limit.  The same numbers end standard error.

Exits non-zero, printing no result, without a CUDA card or with fewer
than the cell asks for, and where the process holds JAX or the JAX
package once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(bench, cell, chips: int, out, traced: bool) -> dict:
    import torch

    from splatbench import check, harness

    ok, checks = check.judge(out.numbers, cell.limits["limits"])
    dev = cell.device
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": chips, "memory_peak_bytes": out.peak_bytes,
              "power_limit": harness.power_limit(dev.index or 0)}
    line = {"correct": bool(ok and out.failed == 0),
            "attempted": out.attempted, "failed": out.failed,
            "metrics": harness.read_metrics(bench, cell.workload, traced,
                                            out.run),
            "device": device}
    if traced:
        tr = out.run.trace
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["checks"] = checks
    return line


def main(argv=None, root=ROOT) -> int:
    args = parse(argv)
    from splatbench import drive, harness

    bench = harness.Bench(root)
    w = bench.workload(args.workload)
    config, traffic = bench.config(w["config"]), bench.traffic(w["traffic"])
    limits = bench.limits(args.workload)
    runner = bench.runner(traffic["kind"])
    chips = int(w["chips"])

    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        print(f"[splatbench] {args.workload} needs {chips} CUDA card(s); "
              f"this machine has {cards}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    cell = drive.Cell(workload=args.workload, config=config, traffic=traffic,
                      limits=limits, seed=args.seed, seconds=args.seconds,
                      traced=bool(args.trace),
                      device=torch.device("cuda", 0), t_start=T_START)
    out = runner.run(cell)
    bad = harness.forbidden_loaded()
    if bad:
        print(f"[splatbench] the process holds {bad} after the window",
              file=sys.stderr)
        return 4
    line = result_line(bench, cell, chips, out, bool(args.trace))
    print(json.dumps(line), flush=True)
    for text in harness.checks_text(line["checks"]):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())

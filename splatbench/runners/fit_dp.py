"""The ``fit_dp`` kind: data-parallel ``fit(method="tiled", mesh=)`` of one
scene over the configuration's ``mesh``, one process a card.

The process that runs the cell is rank 0, on the cell's card; it starts
ranks 1.. on the next cards, each this file run as a script with the cell
in a file beside the world's store.  Rank 0 draws the scene and renders
the targets while they start, then broadcasts both, so every rank starts
from the same tensors.  Every rank then runs what ``runners/fit.py`` runs
on one card, on the mesh: the checked first steps, a short call that
sizes the window, and the window's one call of the steps rank 0 chose,
from the state the first steps left.  ``fit(mesh=)`` splits the views
contiguously over the ranks.  After the first steps rank 0 broadcasts its
leaves, and each rank measures how far its own lie from them
(``rank_gap``: every rank steps with the same averaged gradient).  Rank
0's host clock times the window: every step waits on the all-reduce, so
that clock covers the slowest rank.  A traced run profiles rank 0 alone
and adds to the slice's summary the device time of its NCCL kernels and
the bytes its exchange reduced (``exchange``).

A rank that fails ends the run without a result: rank 0 watches its
ranks and, as soon as one exits non-zero, kills the others and exits; a
rank dies with rank 0 (a parent-death signal); a collective that waits
longer than ``COLLECTIVE_TIMEOUT_S`` fails; and a rank that raises exits
at once, as a process that holds a communicator whose peers are gone may
hang on its way out.

After the window rank 0 joins its ranks and follows the first steps with
the reference: each step the mean loss over every view and one Adam step,
the views taken in blocks, one rank's views a block.

A process runs one such world: a second NCCL world in the process that
ran the first crashed on the card, so ``calibrate.py`` takes one seed a
call for this kind.
"""

from __future__ import annotations

import ctypes
import functools
import json
import math
import os
import pathlib
import signal
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import warnings

if __name__ == "__main__":
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from splatbench import (  # noqa: E402
    check, drive, exchange, harness, poses, scenes, trace)
from splatbench.reference import render as reference  # noqa: E402

FIT_SPAN = "splatbench.fit"
COLLECTIVE_TIMEOUT_S = 120.0
# how long rank 0 waits for its ranks to exit once the window is over
JOIN_S = 120.0
# the command that runs rank r > 0 (the rank's arguments follow)
RANK_COMMAND = [sys.executable, str(pathlib.Path(__file__).resolve())]
CELL_FIELDS = ("workload", "config", "traffic", "limits", "seed", "seconds",
               "traced")
PR_SET_PDEATHSIG = 1


def run(cell: drive.Cell) -> drive.Outcome:
    from splat_tpu_torch.parallel import dryrun

    dev, tr = cell.device, cell.traffic
    ranks = int(cell.config["mesh"]["d"]) * int(cell.config["mesh"]["g"])
    if dev.type == "cuda":
        if torch.cuda.device_count() < ranks:
            raise RuntimeError(f"{cell.workload} needs {ranks} CUDA cards")
        from splat_tpu_torch import _build
        _build.build()          # once, before the ranks load it
    with _World(cell, ranks) as world:
        views = poses.fit_views(tr, poses.base_pose(cell.config["camera"],
                                                    dev))
        truth = scenes.generate(cell.config["scene"], cell.seed, dev)
        targets = torch.stack([reference.render(truth, p,
                                                cell.config["render"]["tile"])
                               for p in views])
        start = dict(truth, sh=truth["sh"] * tr["sh_start_scale"])
        n = truth["means"].shape[0]
        del truth
        drive.free(dev)
        drive.log(f"targets: {time.perf_counter() - cell.t_start:.3f} s")
        dryrun.init_rank(0, ranks, world.store, dev.type,
                         COLLECTIVE_TIMEOUT_S)
        try:
            got = _train(cell, 0, start, targets)
        except BaseException:
            _abort(world)
        dist.destroy_process_group()
        world.join()

    ref = reference_steps(cell, start, views, targets, ranks=ranks)
    numbers = dict(check.fit_numbers(got["first_losses"], ref["losses"],
                                     got["raw"], ref["raw"], ref["raw0"],
                                     ref["gnorm"]), rank_gap=got["rank_gap"])
    drive.log(f"losses: program {got['first_losses']}, reference "
              f"{ref['losses']}; check: "
              f"{time.perf_counter() - cell.t_start:.3f} s")
    steps = got["steps"]
    result = harness.Run(setup_s=got["setup_s"], window_s=got["window_s"],
                         steps=steps, trace=got["summary"],
                         unit_s=got["unit_s"],
                         view_work=ref["work"] if cell.traced else None,
                         pixels=views[0]["h"] * views[0]["w"], params=n * 59)
    return drive.Outcome(run=result, attempted=steps,
                         failed=steps if got["bad"] else 0, numbers=numbers,
                         peak_bytes=got["peak"],
                         kept={"start": start, "views": views,
                               "targets": targets, "reference": ref,
                               "ranks": ranks})


class _World:
    """Rank 0's ranks 1..: started on entry, watched while they run,
    killed on exit if still running; their files under a temporary
    directory."""

    def __init__(self, cell: drive.Cell, ranks: int):
        self.cell, self.ranks = cell, ranks
        self.procs: list = []
        self.done = threading.Event()

    def __enter__(self):
        self.tmp = tempfile.TemporaryDirectory(prefix="splatbench-dp-")
        self.store = os.path.join(self.tmp.name, "store")
        path = os.path.join(self.tmp.name, "cell.json")
        with open(path, "w") as f:
            json.dump({k: getattr(self.cell, k) for k in CELL_FIELDS}, f)
        for r in range(1, self.ranks):
            out = os.path.join(self.tmp.name, f"rank_{r}.out")
            with open(out, "w") as f:
                p = subprocess.Popen(
                    RANK_COMMAND + ["--cell", path, "--parent",
                                    str(os.getpid()), "--rank", str(r),
                                    "--world", str(self.ranks),
                                    "--init-file", self.store, "--device",
                                    self.cell.device.type],
                    stdout=f, stderr=subprocess.STDOUT)
            p.out_path = out
            self.procs.append(p)
        if self.procs:
            drive.log("ranks: pid " + " ".join(str(p.pid)
                                               for p in self.procs))
            threading.Thread(target=self._watch, daemon=True).start()
        return self

    def _watch(self) -> None:
        while not self.done.wait(0.2):
            for r, p in enumerate(self.procs, 1):
                if p.poll() not in (None, 0):
                    self._fail(f"rank {r} exited with code {p.returncode}",
                               p)

    def _fail(self, what: str, p) -> None:
        with open(p.out_path, "rb") as f:
            f.seek(max(os.path.getsize(p.out_path) - 4000, 0))
            tail = f.read().decode(errors="replace")
        drive.log(f"{what}; its output ends:\n{tail}")
        self.kill()
        os._exit(3)

    def join(self) -> None:
        """Wait for every rank to exit; one that fails or outlives
        ``JOIN_S`` ends the run."""
        deadline = time.monotonic() + JOIN_S
        while any(p.poll() is None for p in self.procs):
            if time.monotonic() > deadline:
                late = next(p for p in self.procs if p.poll() is None)
                self._fail(f"a rank still ran {JOIN_S} s after the window",
                           late)
            time.sleep(0.05)
        self.done.set()
        for r, p in enumerate(self.procs, 1):
            if p.returncode:
                self._fail(f"rank {r} exited with code {p.returncode}", p)

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def __exit__(self, *exc):
        self.done.set()
        self.kill()
        self.tmp.cleanup()
        return False


def _abort(world: _World | None = None) -> None:
    """Print the exception being handled, kill ``world``'s ranks and end
    the process at once."""
    traceback.print_exc()
    sys.stderr.flush()
    if world is not None:
        world.kill()
    os._exit(1)


def _train(cell: drive.Cell, rank: int, start=None, targets=None):
    """What every rank runs once the world is up; on rank 0, what the run
    reports."""
    import splat_tpu_torch as stt
    from splat_tpu_torch import train
    from splat_tpu_torch.parallel import sharding

    dev, tr = cell.device, cell.traffic
    start, targets = _share(start, targets, dev)
    mesh = sharding.make_mesh(int(cell.config["mesh"]["d"]),
                              int(cell.config["mesh"]["g"]),
                              device=dev.type)
    views = poses.fit_views(tr, poses.base_pose(cell.config["camera"], dev))
    scene0 = stt.GaussianScene.create(**start, device=dev)
    cams = [stt.Camera(**p) for p in views]
    kw = dict(lr=tr["lr"], lr_scales=dict(tr["lr_scales"]), method="tiled",
              l1_weight=tr["l1_weight"], dssim_weight=tr["dssim_weight"],
              mesh=mesh)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        first = stt.fit(scene0, cams, targets, steps=int(tr["check_steps"]),
                        **kw)
        first_losses = first.losses.tolist()
        raw = {k: getattr(first.raw, k).detach() for k in reference.RAW_LEAVES}
        rank_gap = _rank_gap(raw, reference.raw_from_scene(start), dev)
        drive.log(f"first steps: {time.perf_counter() - cell.t_start:.3f} s")
        drive.sync(dev)
        t0 = time.perf_counter()
        stt.fit(first.scene, cams, targets, steps=int(tr["timing_steps"]),
                **kw)
        drive.sync(dev)
        est = (time.perf_counter() - t0) / int(tr["timing_steps"])
        steps = (int(tr["trace_steps"]) if cell.traced
                 else max(1, math.ceil(cell.seconds / est)))
        steps = int(_from_rank0(steps, dev))
        set_up = len(caught)
        drive.peak_reset(dev)
        summary, unit_s = None, None
        t_win = time.perf_counter()
        if cell.traced:
            stt.fit(first.scene, cams, targets, steps=steps, **kw)
            drive.sync(dev)
            unit_s = (time.perf_counter() - t_win) / steps
            if rank == 0:
                from torch.profiler import record_function
                before = _exchanged(train)
                events: dict = {}
                with trace.traced(events):
                    with record_function(FIT_SPAN):
                        res = stt.fit(first.scene, cams, targets,
                                      steps=steps, **kw)
                summary = _summary(events.pop("events"), steps, before,
                                   _exchanged(train),
                                   int(cell.config["mesh"]["d"]))
                drive.log(f"untraced {unit_s * 1e3:.3f} ms a step over the "
                          f"traced {steps}")
            else:
                res = stt.fit(first.scene, cams, targets, steps=steps, **kw)
        else:
            res = stt.fit(first.scene, cams, targets, steps=steps, **kw)
            drive.sync(dev)
        window_s = summary["window_s"] if summary else (time.perf_counter()
                                                         - t_win)
        peak = drive.peak(dev)
        truncated = [str(w.message) for w in caught[set_up:]
                     if str(w.message).startswith("fit:")]
    bad = bool(truncated) or not bool(torch.isfinite(res.losses).all())
    bad = bool(_max_over_ranks(float(bad), dev))
    drive.log(f"window: {steps} steps in {window_s:.3f} s (estimated "
              f"{est * 1e3:.1f} ms a step), {len(truncated)} truncations, "
              f"peak {peak} B on rank {rank}")
    if rank:
        return None
    return {"first_losses": first_losses, "raw": raw, "rank_gap": rank_gap,
            "steps": steps, "window_s": window_s,
            "setup_s": t_win - cell.t_start, "summary": summary,
            "unit_s": unit_s, "peak": peak, "bad": bad}


def _share(start, targets, dev):
    """Rank 0's scene and targets, on every rank."""
    meta = [None if start is None else (
        {k: tuple(v.shape) for k, v in start.items()}, tuple(targets.shape))]
    dist.broadcast_object_list(meta, src=0, device=dev)
    shapes, t_shape = meta[0]
    if start is None:
        start = {k: torch.empty(s, device=dev) for k, s in shapes.items()}
        targets = torch.empty(t_shape, device=dev)
    for t in (*start.values(), targets):
        dist.broadcast(t, src=0)
    return start, targets


def _from_rank0(value: float, dev) -> float:
    t = torch.tensor([value], dtype=torch.float64, device=dev)
    dist.broadcast(t, src=0)
    return float(t)


def _max_over_ranks(value: float, dev) -> float:
    t = torch.tensor([value], dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def state_gap(raw: dict, lead: dict, raw0: dict) -> float:
    """How far the leaves ``raw`` lie from ``lead``: the worst leaf's norm
    of the difference over the larger of that leaf's change in ``lead``
    (from ``raw0``) and the median leaf's change."""
    change = {k: float(torch.linalg.vector_norm(lead[k] - raw0[k]))
              for k in lead}
    med = sorted(change.values())[len(change) // 2]
    return max(float(torch.linalg.vector_norm(raw[k] - lead[k]))
               / max(change[k], med, 1e-30) for k in lead)


def _rank_gap(raw: dict, raw0: dict, dev) -> float:
    """The largest ``state_gap`` of any rank's leaves from rank 0's."""
    lead = {}
    for k, v in raw.items():
        lead[k] = v.clone()
        dist.broadcast(lead[k], src=0)
    return _max_over_ranks(state_gap(raw, lead, raw0), dev)


def _exchanged(train):
    """(calls, bytes) the program's gradient exchange has counted, or
    None where it counts none."""
    avg = train._Mesh.average
    calls, nbytes = getattr(avg, "calls", None), getattr(avg, "bytes", None)
    return None if calls is None or nbytes is None else (calls, nbytes)


def _summary(events: list, steps: int, before, after, ranks: int) -> dict:
    """``trace.summarize`` of the slice, with the NCCL kernels' device
    time, and the bytes the exchange reduced where the program counts
    them."""
    out = trace.summarize(events, steps)
    out.update(exchange.nccl_seconds(events), ranks=ranks)
    if before is not None and after is not None:
        out["allreduce_calls"] = after[0] - before[0]
        out["allreduce_bytes"] = after[1] - before[1]
    return out


def reference_steps(cell: drive.Cell, start: dict, views, targets, *,
                    ranks: int, feature_dtype=None, only=None) -> dict:
    """The reference's first ``check_steps`` steps from ``start``: losses,
    the raw leaves after them, the start's raw leaves, each leaf's
    gradient norm at the first step and rank 0's views' first forward's
    work.  Each step's loss is the mean of the ranks' blocks' mean
    losses and its gradient the mean of theirs; with ``only``, the block
    of that rank alone (a rank stepping on its own views).
    ``feature_dtype`` puts the control in the program's place."""
    tr = cell.traffic
    recipe = {"l1_weight": tr["l1_weight"],
              "dssim_weight": tr["dssim_weight"]}
    raw0 = reference.raw_from_scene(start)
    raw, adam = raw0, reference.Adam(raw0, tr["lr"], tr["lr_scales"])
    per = len(views) // ranks
    blocks = range(ranks) if only is None else [only]
    losses, gnorm, work = [], None, None
    for s in range(int(tr["check_steps"])):
        loss, grads = 0.0, None
        for b in blocks:
            sl = slice(b * per, (b + 1) * per)
            lb, gb, w = reference.loss_and_grads(
                raw, views[sl], targets[sl], recipe,
                feature_dtype=feature_dtype,
                count=cell.traced and s == 0 and b == 0)
            loss += float(lb)
            if grads is None:
                grads = gb
            else:
                for k in grads:
                    grads[k] += gb[k]
            if s == 0 and b == 0:
                work = w
            del gb
        for k in grads:
            grads[k] /= len(blocks)
        if s == 0:
            gnorm = {k: float(torch.linalg.vector_norm(g))
                     for k, g in grads.items()}
        losses.append(loss / len(blocks))
        raw = adam.step(raw, grads)
    return {"losses": losses, "raw": raw, "raw0": raw0, "gnorm": gnorm,
            "work": work}


def readings(cell: drive.Cell, out: drive.Outcome, control: bool) -> list:
    """The sound run's numbers, and with ``control`` those of the control
    (the reference with bfloat16 per-pair features) and of the faults a
    run can have, each in the program's place against the reference:
    the exchange left out (each rank steps on its own views: rank 0's
    state is its block's alone, the ranks' states differ), a quarter of
    the views (every rank stepping on rank 0's two of the eight: the
    ranks agree) and a state left unchanged."""
    rows = [dict(kind="sound", seed=cell.seed, **out.numbers)]
    if not control:
        return rows
    k = out.kept
    ref = k["reference"]
    steps = functools.partial(reference_steps, cell, k["start"], k["views"],
                              k["targets"], ranks=k["ranks"])

    def against(r, gap=0.0):
        return dict(check.fit_numbers(r["losses"], ref["losses"], r["raw"],
                                      ref["raw"], ref["raw0"], ref["gnorm"]),
                    rank_gap=gap)

    rows.append(dict(kind="control_bf16", seed=cell.seed,
                     **against(steps(feature_dtype=torch.bfloat16))))
    solo = [steps(only=b) for b in range(k["ranks"])]
    rows.append(dict(kind="fault_quarter_views", seed=cell.seed,
                     **against(solo[0])))
    gap = max((state_gap(s["raw"], solo[0]["raw"], ref["raw0"])
               for s in solo[1:]), default=0.0)
    rows.append(dict(kind="fault_exchange_left_out", seed=cell.seed,
                     **against(solo[0], gap)))
    unchanged = check.fit_numbers([ref["losses"][0]] * len(ref["losses"]),
                                  ref["losses"], ref["raw0"], ref["raw"],
                                  ref["raw0"], ref["gnorm"])
    rows.append(dict(kind="fault_state_unchanged", seed=cell.seed,
                     rank_gap=0.0, **unchanged))
    return rows


def _die_with(parent: int) -> None:
    """Have the kernel kill this process when ``parent`` ends (Linux)."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(PR_SET_PDEATHSIG,
                                                signal.SIGKILL)
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:         # it ended before the signal was set
        os._exit(3)


def rank_main(argv=None) -> int:
    """Rank r > 0 of a cell's world (the arguments ``_World`` gives)."""
    from splat_tpu_torch.parallel import dryrun

    ap = dryrun.rank_parser(__doc__.splitlines()[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--parent", type=int, required=True)
    args = ap.parse_args(argv)
    _die_with(args.parent)
    with open(args.cell) as f:
        fields = json.load(f)
    if args.device == "cuda":
        torch.set_num_threads(2)
    dev = dryrun.init_rank(args.rank, args.world, args.init_file,
                           args.device, COLLECTIVE_TIMEOUT_S)
    cell = drive.Cell(**fields, device=dev, t_start=time.perf_counter())
    try:
        _train(cell, args.rank)
    except BaseException:
        _abort()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(rank_main())

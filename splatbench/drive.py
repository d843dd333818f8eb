"""What the runners of the traffic kinds share.

A runner is ``splatbench/runners/<kind>.py``, found by the ``kind`` of a
traffic file (``harness.Bench.runner``).  It has

* ``run(cell) -> Outcome``: builds the cell's inputs from the seed on the
  cell's device, warms the program up, drives its public entry point
  through the window (or, with ``cell.traced``, through an untraced and
  a traced slice of the same work), then checks what the window produced
  against the reference;
* ``readings(cell, outcome, control) -> list``: the numbers the check
  compared, one dict a reading: the sound run's, and with ``control``
  the control's and the faults' in the program's place, for
  ``calibrate.py``.

``run.py`` turns the :class:`Outcome` into the result line.
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from splatbench import harness


@dataclasses.dataclass
class Cell:
    """What a runner needs: the cell's files, the run's arguments, the
    card it runs on and when the process started."""

    workload: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    traced: bool
    device: torch.device
    t_start: float


@dataclasses.dataclass
class Outcome:
    run: harness.Run
    attempted: int
    failed: int
    numbers: dict
    peak_bytes: int
    # what the check compared, for the calibration of its limits
    kept: dict | None = None


def log(msg: str) -> None:
    print(f"[splatbench] {msg}", file=sys.stderr, flush=True)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak_reset(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def peak(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def free(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()

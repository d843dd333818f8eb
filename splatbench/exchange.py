"""The yardstick of data-parallel training's gradient exchange: the bytes a
ring all-reduce moves over each card's links, the links' published peak,
and the device time of the NCCL kernels in a traced slice.

Peak: NVIDIA's H100 SXM data sheet, NVLink 4 at 900 GB/s a card, 450 GB/s
in each direction.  A ring all-reduce of S bytes over n ranks sends (and
receives) 2 (n - 1) / n x S bytes on each card, (n - 1) / n x S in its
reduce-scatter and as much in its all-gather, so it takes at least that
over 450 GB/s.  An NCCL kernel starts when its own rank reaches the
collective and waits inside for the slowest rank to arrive, so its
device time also holds that wait: the share is a lower bound on how well
the exchange uses the links.
"""

from __future__ import annotations

from splatbench import trace

NVLINK_BYTES_PER_S = 450e9
NCCL = "nccl"
ALLREDUCE = "allreduce"


def least_seconds(nbytes: float, ranks: int) -> float:
    """The least time the links allow for a ring all-reduce of ``nbytes``
    over ``ranks``: the bytes each card sends over its peak."""
    return 2.0 * (ranks - 1) / ranks * nbytes / NVLINK_BYTES_PER_S


def nccl_seconds(events: list) -> dict:
    """Device seconds inside the traced window span of every NCCL kernel
    (``nccl_s``) and of the all-reduce kernels among them
    (``allreduce_s``), by the kernels' names."""
    span = next(e for e in events if e.get("ph") == "X"
                and e.get("name") == trace.WINDOW_SPAN
                and e.get("cat") == "user_annotation")
    t0, t1 = float(span["ts"]), float(span["ts"]) + float(span["dur"])
    out = {"nccl_s": 0.0, "allreduce_s": 0.0}
    for e in events:
        name = e.get("name", "").lower()
        if (e.get("ph") != "X" or e.get("cat") not in trace.DEVICE_CATS
                or NCCL not in name or not t0 <= float(e["ts"]) < t1):
            continue
        out["nccl_s"] += float(e["dur"]) * 1e-6
        if ALLREDUCE in name:
            out["allreduce_s"] += float(e["dur"]) * 1e-6
    return out

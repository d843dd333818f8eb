"""allreduce_roofline: the gradient exchange's share of its roofline: the
least time NVLink allows for the ring all-reduce of the bytes the
program's exchange reduced in the traced slice (``_Mesh.average.bytes``;
``exchange.least_seconds``) over the device time of rank 0's NCCL
all-reduce kernels there.  Those kernels also hold the wait for the
slowest rank."""

from splatbench import exchange


def read(run):
    tr = run.trace
    if not run.steps or not tr or not tr.get("allreduce_bytes") \
            or not tr.get("allreduce_s"):
        return None
    least = exchange.least_seconds(tr["allreduce_bytes"], tr["ranks"])
    return 100.0 * least / tr["allreduce_s"]

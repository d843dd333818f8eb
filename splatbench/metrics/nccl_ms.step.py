"""nccl_ms.step: device ms a step of the kernels whose names hold "nccl"
on rank 0, in the traced slice of a data-parallel fit (``exchange``):
the gradient all-reduce, and any other collective the step makes."""


def read(run):
    if not run.steps or not run.trace or "nccl_s" not in run.trace:
        return None
    return run.trace["nccl_s"] / run.trace["units"] * 1e3

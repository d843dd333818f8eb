"""torch_ops_ms.frame: device milliseconds a frame of every operation but
K1 and K2 (and K2's work list): the projection, the binning's scans,
sort, gather and copies."""

from splatbench import trace


def read(run):
    return trace.layer_ms(run, "other") if run.frames else None

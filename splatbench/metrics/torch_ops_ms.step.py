"""torch_ops_ms.step: device milliseconds a step of every operation
outside K1-K4: the projection and its autograd, the loss and its SSIM
blurs, Adam, copies."""

from splatbench import trace


def read(run):
    return trace.layer_ms(run, "other") if run.steps else None

"""idle_share.step: the share of a step's time in which no operation ran
on the card: 100 x (1 - the traced steps' device-busy time a step, the
union of their device intervals, / the host-clock time a step of the
same steps run untraced)."""

from splatbench import trace


def read(run):
    return trace.idle_share(run) if run.steps else None

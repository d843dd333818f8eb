"""idle_share.frame: the share of a frame's time in which no operation ran
on the card: 100 x (1 - the traced frames' device-busy time a frame, the
union of their device intervals, / the host-clock time a frame of the
same frames run untraced)."""

from splatbench import trace


def read(run):
    return trace.idle_share(run) if run.frames else None

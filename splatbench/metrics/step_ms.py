"""step_ms: the host-clock seconds of the window's fit() call over its
steps, in milliseconds."""


def read(run):
    return run.window_s / run.steps * 1e3 if run.steps else None

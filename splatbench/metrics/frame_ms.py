"""frame_ms: the window's host-clock seconds over the frames completed in
it, in milliseconds."""


def read(run):
    return run.window_s / run.frames * 1e3 if run.frames else None

"""frame_p95_ms: the 95th percentile of every frame's latency in the
window, from the request to the image complete on the card (linear
interpolation between order statistics), in milliseconds."""

import numpy as np


def read(run):
    if not run.frames:
        return None
    return float(np.percentile(np.asarray(run.latencies_s), 95)) * 1e3

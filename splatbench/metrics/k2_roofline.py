"""k2_roofline: K2's share of its roofline: the least time the published
peaks allow for compositing the checked frames (``roofline.k2_work``),
over K2's device time a frame (with its work-list kernel) in the traced
slice."""

from splatbench import roofline


def read(run):
    if not run.frames or not run.trace or not run.frame_work:
        return None
    k2_s = run.trace["layers_s"]["k2"] / run.trace["units"]
    if k2_s <= 0:
        return None
    least = sum(roofline.least_seconds(*roofline.k2_work(w, run.pixels))[0]
                for w in run.frame_work) / len(run.frame_work)
    return 100.0 * least / k2_s

"""frame_mfu: the whole frame's share of the card's peak: the least time
the published peaks allow for the frame's work (``roofline.frame_work``:
projection, binning and compositing as the reference counts them on the
checked frames of the traced slice) over the host-clock time a frame of
the same frames run untraced."""

from splatbench import roofline


def read(run):
    if not run.frames or not run.unit_s or not run.frame_work:
        return None
    least = sum(roofline.least_seconds(*roofline.frame_work(w, run.pixels))[0]
                for w in run.frame_work) / len(run.frame_work)
    return 100.0 * least / run.unit_s

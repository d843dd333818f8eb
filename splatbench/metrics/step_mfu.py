"""step_mfu: the whole training step's share of the card's peak: the
least time the published peaks allow for a step (``roofline.step_work``:
its views' projection and backward, binning, K3, K4 and loss, then Adam)
over the host-clock time a step of the traced steps run untraced."""

from splatbench import roofline


def read(run):
    if not run.steps or not run.unit_s or not run.view_work:
        return None
    least = roofline.least_seconds(*roofline.step_work(
        run.view_work, run.pixels, run.params))[0]
    return 100.0 * least / run.unit_s

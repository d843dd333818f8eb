"""k3_roofline: K3's share of its roofline: the least time the published
peaks allow for the training forward's walk of the views
(``roofline.k3_work``) over K3's device time a step (with its work-list
kernel) in the traced slice."""

from splatbench import roofline


def read(run):
    if not run.steps or not run.trace or not run.view_work:
        return None
    spent = run.trace["layers_s"]["k3"] / run.trace["units"]
    if spent <= 0:
        return None
    least = sum(roofline.least_seconds(*roofline.k3_work(w, run.pixels))[0]
                for w in run.view_work)
    return 100.0 * least / spent

"""densify_ms.round: host-clock ms of an adaptive density control round,
the program's ``stt.fit.densify`` span (selection, copies, padding, the
capacity re-audit and Adam's restart) averaged over the rounds of the
traced slice (``runners/fit_adc.py``); None where the slice holds no such
span."""


def read(run):
    t = run.trace
    if not t or not t.get("densify_rounds"):
        return None
    return t["densify_s"] / t["densify_rounds"] * 1e3

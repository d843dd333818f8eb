"""setup_s: host-clock seconds from the start of the process to the
window: imports, the card, the kernel build where the checkout has none,
the scene, the inputs and every warm-up."""


def read(run):
    return run.setup_s

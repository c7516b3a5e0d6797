"""setup_s: seconds from the start of the run to the opening of the
window: imports, building or loading the kernels, the app, the scenes, the
warm-up of every batch size and the traffic's lead-in."""


def read(run):
    return run.setup_s

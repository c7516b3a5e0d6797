"""served_fps: maps published on every rig's out slot in the window, per
second of the window."""


def read(run):
    if run.window_s <= 0 or not run.served:
        return None
    return run.served / run.window_s

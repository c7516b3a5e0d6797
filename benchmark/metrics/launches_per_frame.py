"""launches_per_frame: kernels, copies and memsets in the traced slice per
frame the device matched in it, a frame being two B3 aggregation
passes."""

from benchmark import roofline


def read(run):
    tr = run.device_trace
    if tr is None:
        return None
    passes = sum(n for name, (_, n) in tr.by_name.items()
                 if roofline.aggregate_kernel(name))
    frames = passes / roofline.AGGREGATE_PASSES_PER_FRAME
    if frames <= 0 or tr.events <= 0:
        return None
    return tr.events / frames

"""sgm_aggregate_roofline: share of its roofline that B3 reaches in the
traced slice: the least time of the aggregation passes the served chain
made there (each input byte read once, each output byte written once, at
the card's peak bandwidth; or their operations at the float32 peak, where
that is longer), over the time the device spent in B3's kernels
(``sgm_aggregate_lanes_kernel``, ``sgm_aggregate_wide_kernel``: the names
``benchmark/roofline.py`` keeps). Nothing where the slice holds no B3
launch or a launch whose types the name does not give."""

from benchmark import roofline


def read(run):
    tr = run.device_trace
    if tr is None:
        return None
    cfg = run.config
    planes = cfg["params"]["max_disparity"] + 1
    least = spent = 0.0
    for name, (seconds, launches) in tr.by_name.items():
        if roofline.aggregate_kernel(name) is None:
            continue
        work = roofline.aggregate_pass(name, planes, cfg["height"],
                                       cfg["width"])
        if work is None:
            return None
        nbytes, ops = work
        least += launches * roofline.bound_s(nbytes, ops,
                                             roofline.F32_OPS)[0]
        spent += seconds
    if spent <= 0:
        return None
    return 100.0 * least / spent

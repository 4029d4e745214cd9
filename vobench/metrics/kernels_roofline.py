"""``kernels_roofline``: the port's six CUDA kernels' share of their roofline, %.

Σ least time ÷ Σ device time over the launches of K1-K6 in the median
profiler session; each launch's least time from ``vobench.kernels`` (the
frozen bytes and operations, the published H100 peaks).
"""

from vobench.kernels import launch_bound_s


def read(ctx):
    prof = ctx["profile"]
    if prof is None:
        return None
    bound = spent = 0.0
    for d in prof["device"]:
        if d["cat"] != "kernel":
            continue
        b = launch_bound_s(d["name"], d["grid"], d["block"], ctx["n_features"])
        if b is not None:
            bound += b
            spent += d["end"] - d["start"]
    return 100.0 * bound / spent if spent > 0.0 else None

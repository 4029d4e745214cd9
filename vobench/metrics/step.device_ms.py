"""``step.device_ms``: the step graph's device time a frame, in ms.

The median of the handler's ``dev_step_graph`` (its device span around the
step graph's replay, opened after the host has staged the graph's inputs:
CUDA events on the stream, stated on the host's clock) over the calls of the
stage-timer window whose finalised frame held no keyframe event.  Nothing
where the program records no device interval.
"""

import statistics


def read(ctx):
    v = [r["dev_step_graph"] for r in ctx["stages"]
         if r.get("dev_step_graph", 0.0) > 0.0 and r.get("timer_kf_event", 0.0) == 0.0]
    return 1e3 * statistics.median(v) if v else None

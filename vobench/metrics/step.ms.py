"""``step.ms``: the step graph's time a frame, in ms.

The median of the handler's ``fused_dispatch`` stage (its fenced timer, so the
step's device work included) over the calls of the stage-timer window whose
finalised frame held no keyframe event.
"""

import statistics


def read(ctx):
    v = [r["timer_fused_dispatch"] for r in ctx["stages"]
         if r.get("timer_fused_dispatch", 0.0) > 0.0 and r.get("timer_kf_event", 0.0) == 0.0]
    return 1e3 * statistics.median(v) if v else None

"""``ba.assemble_ms``: the host assembly of a keyframe event's windowed BA
problem, in ms.

The median of the handler's ``ba_assemble`` span (the covisible window, its
points and observation cells, packed as host arrays; no device work) over the
calls of the stage-timer window that ran a windowed BA.  Nothing where the
program does not record the span.
"""

import statistics


def read(ctx):
    v = [r["timer_ba_assemble"] for r in ctx["stages"]
         if r.get("timer_local_ba", 0.0) > 0.0 and r.get("timer_ba_assemble", 0.0) > 0.0]
    return 1e3 * statistics.median(v) if v else None

"""``ba.ms``: the windowed BA of a keyframe event, in ms.

The median of the handler's ``local_ba`` stage (the problem's host assembly,
its upload, the solve and the write-back; fenced) over the calls of the
stage-timer window that ran one.
"""

import statistics


def read(ctx):
    v = [r["timer_local_ba"] for r in ctx["stages"] if r.get("timer_local_ba", 0.0) > 0.0]
    return 1e3 * statistics.median(v) if v else None

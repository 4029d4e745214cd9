"""``kf_event.ms``: the keyframe event's own time, in ms.

The median, over the calls of the stage-timer window that finalised a keyframe
event, of the handler's ``kf_event`` stage less its ``local_ba`` stage: the
map work (``feature_detection``: the map graph's dispatch and finish), the
backfill sweeps, the seed lifecycle and the host bookkeeping of the event.
"""

import statistics


def read(ctx):
    v = [r["timer_kf_event"] - r.get("timer_local_ba", 0.0) for r in ctx["stages"]
         if r.get("timer_kf_event", 0.0) > 0.0]
    return 1e3 * statistics.median(v) if v else None

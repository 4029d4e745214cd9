"""``ba.solve_device_ms``: the device time of a keyframe event's windowed BA
solve, in ms.

The median of the handler's ``dev_ba_solve`` (its device span around the
solve graph's replay, opened after the problem's uploads and the graph's
staging are queued) over the calls of the stage-timer window that ran a
windowed BA.  Nothing where the program records no device interval.
"""

import statistics


def read(ctx):
    v = [r["dev_ba_solve"] for r in ctx["stages"]
         if r.get("timer_local_ba", 0.0) > 0.0 and r.get("dev_ba_solve", 0.0) > 0.0]
    return 1e3 * statistics.median(v) if v else None

"""``kf_event.map_device_ms``: the device time of a keyframe event's map work,
in ms.

The median of the handler's ``dev_kf_map`` (its device spans around the map
graph's and the backfill graph's replays and the seed harvest's gather, each
opened after the host has staged the work's inputs) over the calls of the
stage-timer window that finalised a keyframe event.  Nothing where the
program records no device interval.
"""

import statistics


def read(ctx):
    v = [r["dev_kf_map"] for r in ctx["stages"]
         if r.get("timer_kf_event", 0.0) > 0.0 and r.get("dev_kf_map", 0.0) > 0.0]
    return 1e3 * statistics.median(v) if v else None

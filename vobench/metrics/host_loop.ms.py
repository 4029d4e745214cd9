"""``host_loop.ms``: the handler's own host time a frame, in ms.

The median of the handler's ``timer_host_self`` (a call's host time less the
part of it that device intervals cover) over the calls of the stage-timer
window whose finalised frame held no keyframe event.  The window is traced
with fenced stages, so this is the host's serialised work a call: in a
synchronous cell (``euroc.live``) it adds to each frame's latency; in the
lag-1 loop (``icl-nuim.replay``) it overlaps the previous frame's step on the
device and adds to p50 only past the step's device time.  Nothing where the
program does not record it.
"""

import statistics


def read(ctx):
    v = [r["timer_host_self"] for r in ctx["stages"]
         if r.get("timer_host_self", 0.0) > 0.0 and r.get("timer_kf_event", 0.0) == 0.0]
    return 1e3 * statistics.median(v) if v else None

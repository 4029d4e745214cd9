"""``device.idle_share``: the share of a frame's wall time the device is idle, %.

100 × (1 − device-busy seconds a frame ÷ wall seconds a frame).  Busy is the
union of the kernel, copy and fill intervals of the median profiler session
(the traced run's last segment), over its frames; wall is the plain segment
before it (host clock, no timer, no profiler), over its frames.
"""


def read(ctx):
    prof, plain = ctx["profile"], ctx["plain"]
    if prof is None or not prof["device"] or prof["frames"] == 0 or plain["frames"] == 0:
        return None
    busy = prof["busy_s"] / prof["frames"]
    wall = plain["seconds"] / plain["frames"]
    return 100.0 * (1.0 - busy / wall)

"""What a traced run reads: the handler's stage-timer CSV (segment 1) and a
``torch.profiler`` device trace (segment 3), reduced to plain records that the
per-layer readers under ``vobench/metrics/`` take their numbers from.
"""

from __future__ import annotations

import csv
import json
import os

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SESSION = "vobench.session"


def read_stage_csv(path: str) -> list[dict]:
    """One dict a row (a handler call) of the stage CSV: column → float."""
    with open(path) as fh:
        return [{k: float(v) for k, v in row.items()} for row in csv.DictReader(fh)]


def merge(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals, sorted and disjoint."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def read_chrome_trace(path: str) -> dict:
    """The device operations, the host operations and the session window of
    an exported trace; times in seconds from the trace's origin."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    dev, host, window = [], [], None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ts, dur = float(e["ts"]) * 1e-6, float(e["dur"]) * 1e-6
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            args = e.get("args", {})
            dev.append(dict(name=e.get("name", ""), cat=cat, start=ts, end=ts + dur,
                            grid=args.get("grid", [1, 1, 1]),
                            block=args.get("block", [1, 1, 1])))
        elif e.get("name") == SESSION:
            if window is None or dur > window[1] - window[0]:
                window = (ts, ts + dur)
        elif cat in ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"):
            host.append(dict(name=e.get("name", ""), start=ts, end=ts + dur))
    return dict(device=dev, host=host, window=window)


def reduce_session(tr: dict) -> dict:
    """Busy seconds (the union of device intervals inside the session), the
    session's seconds, its device operations, and the host operation under
    each idle gap of the device."""
    w0, w1 = tr["window"]
    dev = [d for d in tr["device"] if d["end"] > w0 and d["start"] < w1]
    busy = merge((max(d["start"], w0), min(d["end"], w1)) for d in dev)
    gaps = []
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    gaps.sort(key=lambda g: g[0] - g[1])

    def host_at(t: float) -> str:
        # the innermost host operation running when the device went idle
        best = None
        for h in tr["host"]:
            if h["start"] <= t < h["end"] and h["name"] != SESSION:
                if best is None or h["end"] - h["start"] < best["end"] - best["start"]:
                    best = h
        return best["name"] if best is not None else "no host operation"

    return dict(busy_s=sum(b - a for a, b in busy), window_s=w1 - w0, device=dev,
                gaps=[(host_at(a), b - a) for a, b in gaps[:10]])


def breakdown(sess: dict) -> dict:
    """The ten device operations that took most time (by name), and the ten
    longest idle gaps by what the host was doing."""
    tot: dict[str, float] = {}
    for d in sess["device"]:
        tot[d["name"]] = tot.get(d["name"], 0.0) + d["end"] - d["start"]
    ops = sorted(tot.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in sess["gaps"]]}


def pick_session(sessions: list) -> dict | None:
    """The session with the median count of device operations a frame.  Not
    the fullest: in a mix with rare keyframe events the fullest is the one
    that caught an event, whose busy time a frame the plain segment's mix
    does not have; a lost record (a session can lose one) moves the count by
    one in thousands."""
    if not sessions:
        return None
    ranked = sorted(sessions, key=lambda s: len(s["device"]) / max(s["frames"], 1))
    return ranked[(len(ranked) - 1) // 2]


def profile(run_frames, n_sessions: int, out_dir: str, sync, cuda: bool = True) -> dict:
    """``n_sessions`` profiler sessions, each around one call of
    ``run_frames()`` (which returns the frames it ran) and the device
    synchronise ``sync``; the median one (:func:`pick_session`) reduced,
    with its frame count."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    sessions = []
    for i in range(n_sessions):
        sync()
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(SESSION):
                n = run_frames()
                sync()
        path = os.path.join(out_dir, f"session{i}.json")
        prof.export_chrome_trace(path)
        tr = read_chrome_trace(path)
        os.remove(path)
        if tr["window"] is None:
            continue
        sess = reduce_session(tr)
        sess["frames"] = n
        sessions.append(sess)
    return pick_session(sessions)

"""Where a keyframe event's time goes on the GPU, part by part.

Run from the repository root on a machine with one CUDA device:

    python3 -m hso_tpu_torch.tools.profile_keyframe [--events 3] [--out FILE]

Runs the evolving-map scan of ``chip_smoke.py`` (state resumed from
``artifacts/bench_boot.npz``) for ``6 * events`` frames under
``torch.profiler``, with the device synchronised and a marker kernel launched
around the functions the keyframe body calls.  That cuts each keyframe event
into its parts — the registration and compaction before the BA, the BA
(``local_bundle_adjustment``), the write-back, the seed harvest
(``harvest_and_prune``), the activation and occupancy grid, detection
(``detect_features``), the bearings, ``init_seeds`` — and prints one JSON
object: per part the host ms (synchronised, median over the events), the
device kernels launched and the device-busy ms; and the same for the frame
step of a frame without an event.  A part's host time includes its wait for
the device, so the parts add up to the event's synchronised wall time.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

#: the functions the keyframe body calls, in call order; a marker goes before
#: and after each
CALLS = ("local_bundle_adjustment", "harvest_and_prune", "detect_features", "init_seeds")
#: the parts between consecutive markers
PARTS = ("registration and compaction", "BA", "BA write-back", "harvest",
         "activation and occupancy", "detection", "bearings", "init_seeds", "counters")


def main() -> int:
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    from hso_tpu_torch.pipeline import keyframe, scan
    from hso_tpu_torch.utils import checkpoint

    ap = argparse.ArgumentParser()
    ap.add_argument("--events", type=int, default=3)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_keyframe: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    scan.pin_float32_matmul()
    card = cs.card_line()
    cam, cfg = cs.bench_camera(), cs.Config()
    carry0, meta = checkpoint.scan_state_from_checkpoint(cs.BOOT_NPZ, cam, cfg, device)
    n = scan.KF_EVERY * args.events
    start = meta["frame_count"]
    frames = torch.as_tensor(cs.render_frames(cs.bench_scene(cam),
                                              cs.trajectory(start + n)[start:])).to(device)
    step = scan.make_scan_step(cam, cfg, device)
    args_scan = (cam, cfg, meta["px_error_angle"], device)
    cs.run_scan_timed(step, carry0, frames[:scan.KF_EVERY], *args_scan)     # warm

    stamps = []                 # host time at each marker, in order

    def mark():
        torch.cuda.synchronize(device)
        stamps.append(time.perf_counter())
        torch.cuda._sleep(1)

    def marked(fn):
        def call(*a, **kw):
            mark()
            out = fn(*a, **kw)
            mark()
            return out
        return call

    frame_t = []

    def on_frame(i, kf, out, carry):
        torch.cuda.synchronize(device)
        frame_t.append(time.perf_counter())

    with cs.patched([(keyframe, name, marked(getattr(keyframe, name))) for name in CALLS]), \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        scan.run_scan(step, carry0, frames, cam, cfg, meta["px_error_angle"],
                      on_frame=on_frame)
    events = sorted((e for e in prof.events()
                     if str(getattr(e, "device_type", "")).endswith("CUDA")),
                    key=lambda e: e.time_range.start)

    # device events between markers: per keyframe event, 2·len(CALLS) markers
    # cut the body into len(CALLS) calls and the glue between them; the step
    # before the first marker of an event and after its last belongs to frames
    segs, cur = [], []
    for e in events:
        if "spin_kernel" in e.name:
            segs.append(cur)
            cur = []
        else:
            cur.append(e.time_range.elapsed_us())
    segs.append(cur)
    n_mark = 2 * len(CALLS)
    assert len(segs) == args.events * n_mark + 1, f"{len(segs)} segments"
    kf_frames = [i for i in range(n) if scan.is_keyframe(i)]
    ends = [t0] + frame_t
    parts = {p: {"host_ms": [], "device_kernels": [], "device_busy_ms": []} for p in PARTS}
    for j, i in enumerate(kf_frames):
        st = stamps[j * n_mark:(j + 1) * n_mark]
        # host: step start .. first marker is the frame step plus the
        # registration; the step's own time is taken from the frames without
        # an event, and the registration is the remainder
        host = [b - a for a, b in zip(st[:-1], st[1:])]
        host = [st[0] - ends[i]] + host + [ends[i + 1] - st[-1]]
        dev = segs[j * n_mark:(j + 1) * n_mark + 1]
        for k, p in enumerate(PARTS):
            parts[p]["host_ms"].append(host[k] * 1e3)
            if 0 < k < len(PARTS) - 1:
                parts[p]["device_kernels"].append(len(dev[k]))
                parts[p]["device_busy_ms"].append(sum(dev[k]) / 1e3)
    plain = [(ends[i + 1] - ends[i]) * 1e3 for i in range(n) if not scan.is_keyframe(i)]
    step_ms = statistics.median(plain)
    parts["registration and compaction"]["host_ms"] = [
        h - step_ms for h in parts["registration and compaction"]["host_ms"]]
    doc = {"card": card, "keyframe_events": args.events, "frames": n,
           "frame_step_host_ms_median": step_ms,
           "keyframe_frame_host_ms": [(ends[i + 1] - ends[i]) * 1e3 for i in kf_frames],
           "parts": {p: {k: (statistics.median(v) if v else "not separated from the step")
                         for k, v in d.items()} for p, d in parts.items()}}
    text = json.dumps(doc)
    print(text, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

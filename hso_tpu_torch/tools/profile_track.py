"""Where a frame's time goes on the GPU.

Run from the repository root on a machine with one CUDA device:

    python3 -m hso_tpu_torch.tools.profile_track [--step frame|track|both]
                                                 [--frames 8] [--out FILE]

Runs the same frames as ``chip_smoke.py`` (state and seed table resumed from
``artifacts/bench_boot.npz``) through the whole per-frame step
(``make_frame_step``, the default), the tracking half (``make_track_step``)
or both in turn; warms up, then records ``--frames`` steps under
``torch.profiler`` and prints one JSON object per step: wall time per frame
(host clock around a synchronised step), device-busy share (sum of device
kernel time over wall time), device kernels launched per frame, the device
time of the six hand-written kernels, the device time per launch of K3 (the
coarse level loop) by pyramid level and pattern size, and the ten heaviest
device kernels.  If the profiler reports no device time the object says so and carries only
the wall times.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

OWN_KERNELS = ("extract_windows_kernel", "pack_level_windows_kernel", "coarse_level_ic_kernel",
               "align_match_kernel", "pose_lm_kernel", "zmncc_line_kernel")


def k3_by_level(prof, shapes, h0: int):
    """Device time per launch of K3 by level: the profiler's K3 kernel events
    in start order, matched with the shapes noted at the call site."""
    events = sorted((e for e in prof.events()
                     if "coarse_level_ic_kernel" in e.name
                     and str(getattr(e, "device_type", "")).endswith("CUDA")),
                    key=lambda e: e.time_range.start)
    if len(events) != len(shapes):
        return f"not measured: {len(events)} K3 kernel events for {len(shapes)} launches"
    by = {}
    for e, (h, p) in zip(events, shapes):
        level = (h0 // h).bit_length() - 1
        by.setdefault(f"level {level} (P={p}, image height {h})", []).append(
            e.time_range.elapsed_us() / 1e3)
    return {k: {"launches": len(v), "ms_median": statistics.median(v), "ms_mean": sum(v) / len(v)}
            for k, v in by.items()}


def profile_step(cs, which: str, cam, cfg, device, args, card: str) -> dict:
    whole = which == "frame"
    step, _, _ = cs.build_step(cam, cfg, device, whole=whole)
    state, book = cs.initial_state(cam, cfg, device)
    frame_count = book["frame_count"]
    n = args.warm + args.frames
    scene = cs.bench_scene(cam)
    frames = [scene.render(T) for T in cs.trajectory(frame_count + n)[frame_count:]]

    for img in frames[:args.warm]:
        state = cs.advance(state, cs.run_one(step, state, img, whole))
    torch.cuda.synchronize(device)

    wall_ms = []
    from torch.profiler import ProfilerActivity, profile

    from hso_tpu_torch.track import coarse_cuda, coarse_tracker

    k3_shapes = []            # (image height, P) of every K3 launch, in launch order

    def k3_noting_shape(*a, **kw):
        k3_shapes.append((kw["h_img"], a[1].shape[1]))
        return coarse_cuda.coarse_level_ic(*a, **kw)

    with cs.patched([(coarse_tracker, "coarse_level_ic", k3_noting_shape)]), \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for img in frames[args.warm:]:
            t0 = time.perf_counter()
            out = cs.run_one(step, state, img, whole)
            torch.cuda.synchronize(device)
            wall_ms.append((time.perf_counter() - t0) * 1e3)
            state = cs.advance(state, out)
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        is_dev = str(getattr(e, "device_type", "")).endswith("CUDA")
        if dev_us > 0 and is_dev:
            rows.append((e.key, dev_us, e.count))
    doc = {"step": which, "card": card, "frames": args.frames,
           "wall_ms_per_frame_median": statistics.median(wall_ms),
           "wall_ms_per_frame": wall_ms}
    if not rows:
        doc["device_time"] = "not measured: the profiler reported no device time"
    else:
        total_us = sum(r[1] for r in rows)
        doc["device_busy_ms_per_frame"] = total_us / 1e3 / args.frames
        doc["device_busy_share"] = total_us / 1e3 / sum(wall_ms)
        doc["device_kernels_per_frame"] = sum(r[2] for r in rows) / args.frames
        doc["own_kernels_ms_per_frame"] = {
            k: sum(r[1] for r in rows if k in r[0]) / 1e3 / args.frames for k in OWN_KERNELS}
        doc["own_kernels_calls_per_frame"] = {
            k: sum(r[2] for r in rows if k in r[0]) / args.frames for k in OWN_KERNELS}
        doc["k3_ms_per_launch_by_level"] = k3_by_level(prof, k3_shapes, cam.height)
        rows.sort(key=lambda r: -r[1])
        doc["top_device_kernels"] = [
            {"name": r[0][:90], "ms_per_frame": r[1] / 1e3 / args.frames,
             "calls_per_frame": r[2] / args.frames} for r in rows[:10]]
    return doc


def main() -> int:
    import chip_smoke as cs

    ap = argparse.ArgumentParser()
    ap.add_argument("--step", choices=("frame", "track", "both"), default="frame")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--warm", type=int, default=4)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_track: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0].strip()

    cam, cfg = cs.bench_camera(), cs.Config()
    steps = ("track", "frame") if args.step == "both" else (args.step,)
    text = "\n".join(json.dumps(profile_step(cs, which, cam, cfg, device, args, card))
                     for which in steps)
    print(text, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Benchmark of the port: the evolving-map scan on one GPU.

    python -m hso_tpu_torch.bench [--device cpu]

Headline metric ``pipeline_frames_per_s``: the whole per-frame step
(pyramid and Sobel, coarse-to-fine photometric tracking, grid selection and
matching, motion-only pose LM, the depth-filter seed sweep) plus the keyframe
work every ``KF_EVERY``-th frame (observation-ring registration, the windowed
Schur BA with its write-back, seed harvest and activation, detection feeding
new seeds), over 192 frames (:func:`hso_tpu_torch.pipeline.scan.run_scan`).

Protocol, as the JAX package's ``bench.py`` has it:
  * the map, the seed table and the tracking reference resume from
    ``artifacts/bench_boot.npz`` (a snapshot of the live pipeline at frame 55);
  * the frames are the box scene rendered along the benchmark's trajectory,
    staged on the device before timing;
  * one untimed warm pass over the first 12 frames (kernel build, allocator,
    library handles), then 2 timed scans from the same start state, each
    ending in a device synchronise inside the timed window;
  * the trajectory is checked against ground truth with scale-aligned ATE:
    above 0.10 m the pipeline is mis-tracking, and the bench prints
    ``"value": null`` and exits 1.

Secondary metric ``host_loop_frames_per_s``: the synchronous host loop
users call, ``FrameHandler.add_image``
(:mod:`hso_tpu_torch.pipeline.frame_handler`), resumed from the same
checkpoint, warmed through its first three keyframe events (at most
``N_HOST_WARM`` frames), then timed over ``N_HOST`` frames of the same
trajectory.  The handler decides its own keyframes, so the timed frames hold
whatever events it takes.  Its ATE over the warm and timed frames is held to
the same gate.  (The JAX bench times its lag-1 ``add_image_pipelined``, which
is not ported; the JSON line says which loop was timed.)

``vs_baseline`` is printed as null, with its reason.  Runs on the GPU unless
``--device cpu`` is given; without a GPU and without that flag it exits 2.
Prints one JSON line on stdout, phases on stderr; writes no file.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from hso_tpu_torch.cameras import PinholeCamera
from hso_tpu_torch.config import Config
from hso_tpu_torch.math import se3np
from hso_tpu_torch.pipeline import scan
from hso_tpu_torch.pipeline.frame_handler import RESULT_KEYFRAME, STAGE_DEFAULT, FrameHandler
from hso_tpu_torch.utils.checkpoint import load_checkpoint, scan_state_from_checkpoint
from hso_tpu_torch.utils.evaluate import ate
from hso_tpu_torch.utils.synthetic import BoxScene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOOT_NPZ = os.path.join(ROOT, "artifacts", "bench_boot.npz")
N_SCAN = 192
N_WARM = 12
N_REPEATS = 2
N_HOST = 16            #: timed frames of the synchronous host loop
N_HOST_WARM = 20       #: at most this many warm frames (three keyframe events)
ATE_GATE_M = 0.10

_T0 = time.perf_counter()


def _phase(msg: str) -> None:
    print(f"[bench {time.perf_counter() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def bench_camera() -> PinholeCamera:
    return PinholeCamera(640, 480, 400.0, 400.0, 320.0, 240.0)


def bench_scene(cam) -> BoxScene:
    return BoxScene(cam, half_width=2.0, half_height=1.5, depth=4.5, seed=3, stepped_back=True)


def trajectory(n: int) -> list:
    """Brisk oscillating sweep inside the box (the benchmark's trajectory)."""
    poses = []
    for k in range(n):
        t = k / 18.0
        xi = np.r_[0.8 * np.sin(0.8 * t), 0.12 * np.sin(0.5 * t), 0.10 * np.sin(0.35 * t),
                   0.02 * np.sin(0.9 * t), -0.05 * np.sin(0.6 * t), 0.02 * np.sin(0.4 * t)]
        poses.append(se3np.exp(xi))
    return poses


def render_frames(scene, poses) -> np.ndarray:
    """The scene at each pose, (N, H, W) uint8, rendered on a few threads
    (numpy releases the GIL in the ray casts and texture reads)."""
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        return np.stack(list(pool.map(scene.render, poses)))


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0].strip()


def scan_ate(traj: np.ndarray, gt_poses) -> float:
    """Scale-aligned ATE RMSE of the scan's poses (world→camera) in metres."""
    est = np.stack([se3np.translation(se3np.inv(se3np.normalize(T.astype(np.float64))))
                    for T in traj])
    gt = np.stack([se3np.translation(se3np.inv(T)) for T in gt_poses])
    return ate(est, gt, with_scale=True).rmse


def host_loop(cam, cfg, scene, device, sync) -> dict:
    """``FrameHandler.add_image`` from the checkpoint: warm through three
    keyframe events (at most ``N_HOST_WARM`` frames), then ``N_HOST`` timed
    frames (host images, uploaded by the handler), ending in a device
    synchronise.  Returns frames/s over the timed frames, the keyframe events
    among them, and the ATE of every frame run."""
    vo = FrameHandler(cam, cfg, device=device)
    load_checkpoint(vo, BOOT_NPZ, resume_stage="default")
    start = vo.frame_count
    gt = trajectory(start + N_HOST_WARM + N_HOST)[start:]
    frames = render_frames(scene, gt)        # host images, as a user passes them
    k = n_kf = 0
    while k < N_HOST_WARM and n_kf < 3:
        n_kf += vo.add_image(frames[k], ts=float(start + k)).status == RESULT_KEYFRAME
        k += 1
    sync()
    t0 = time.perf_counter()
    timed = [vo.add_image(frames[j], ts=float(start + j)) for j in range(k, k + N_HOST)]
    sync()
    seconds = time.perf_counter() - t0
    if vo.stage != STAGE_DEFAULT:
        raise RuntimeError(f"the host loop lost tracking: stage {vo.stage}")
    traj = np.stack([T for _, T in vo.trajectory])
    return dict(fps=N_HOST / seconds, seconds=seconds, warm_frames=k, warm_keyframes=n_kf,
                timed_keyframes=sum(r.status == RESULT_KEYFRAME for r in timed),
                min_inliers=min(r.n_inliers for r in timed),
                ate=scan_ate(traj, gt[:len(traj)]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("bench: no CUDA device (torch.cuda.is_available() is False); "
              "pass --device cpu to run on the CPU", file=sys.stderr)
        return 2
    on_card = device.type == "cuda"
    scan.pin_float32_matmul()
    card = card_line() if on_card else "cpu"

    cam, cfg = bench_camera(), Config()
    carry0, meta = scan_state_from_checkpoint(BOOT_NPZ, cam, cfg, device)
    start = meta["frame_count"]
    _phase(f"state resumed at frame {start}")
    gt = trajectory(start + N_SCAN)[start:]
    scene = bench_scene(cam)
    frames = torch.as_tensor(render_frames(scene, gt)).to(device)
    _phase(f"{N_SCAN} frames rendered and staged")
    step = scan.make_scan_step(cam, cfg, device)

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    def run(n):
        return scan.run_scan(step, carry0, frames[:n], cam, cfg, meta["px_error_angle"])

    run(N_WARM)
    sync()
    _phase("warm pass done")
    times = []
    for _ in range(N_REPEATS):
        sync()
        t0 = time.perf_counter()
        res = run(N_SCAN)
        sync()
        times.append(time.perf_counter() - t0)
    traj = res["traj"].cpu().numpy()
    chk = float(res["chk"])
    fps = N_SCAN * N_REPEATS / sum(times)
    _phase(f"scan timed: {fps:.3f} frames/s ({[round(t, 3) for t in times]} s)")

    rmse = scan_ate(traj, gt)
    host = host_loop(cam, cfg, scene, device, sync)
    _phase(f"host loop timed: {host['fps']:.3f} frames/s ({host['warm_frames']} warm frames, "
           f"{host['timed_keyframes']} keyframe events timed)")
    doc = {"metric": "pipeline_frames_per_s", "unit": "frames/s", "device": str(device),
           "card": card, "frames": N_SCAN, "repeats": N_REPEATS,
           "keyframe_events": sum(scan.is_keyframe(i) for i in range(N_SCAN)),
           "scan_seconds": times}
    if not (np.isfinite(chk) and rmse < ATE_GATE_M and host["ate"] < ATE_GATE_M):
        doc.update(value=None, vs_baseline=None, scan_ate_rmse_m=rmse,
                   host_loop_ate_rmse_m=host["ate"],
                   error=f"scan ATE RMSE {rmse:.4f} m or host-loop ATE RMSE {host['ate']:.4f} m "
                         f"exceeds the {ATE_GATE_M} m gate, or the check sum {chk} is not "
                         "finite: the pipeline is mis-tracking; frames/s withheld")
        print(json.dumps(doc), flush=True)
        return 1
    doc.update(
        value=fps, pipeline_frames_per_s=fps, scan_ate_rmse_m=rmse,
        min_inliers=int(res["n_inliers"].min()), check_sum=chk,
        host_loop_frames_per_s=host["fps"], host_loop="add_image (synchronous)",
        host_loop_frames=N_HOST, host_loop_seconds=host["seconds"],
        host_loop_keyframe_events=host["timed_keyframes"],
        host_loop_min_inliers=host["min_inliers"], host_loop_ate_rmse_m=host["ate"],
        vs_baseline=None,
        baseline_note="not computed: BASELINE_CPU.json was measured on another host; the CPU "
                      "anchor has not been measured on this one")
    print(json.dumps(doc), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

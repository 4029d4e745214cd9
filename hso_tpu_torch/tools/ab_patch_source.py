"""A/B of the matcher's patch source: the most recent view against the closest.

The port's counterpart of the JAX package's ``scripts/ab_patch_source.py``.
Each map point keeps one memoized patch view, refreshed at every keyframe that
observes it (``Config.patch_source = "recency"``); ``"closest"`` also keeps
the host view and picks, per match, the one whose viewing angle is smaller.
The pendulum trajectory (a wide, slow lateral sweep with yaw that swings back
through earlier viewpoints twice a period, from frame ≈ n/2 on) is the case
where the most recent view is not the closest.  Both settings run through
``FrameHandler.add_image`` over the same rendered frames; the artifact records
ATE, matches a tracked frame (mean and 10th percentile), failures, and on the
recency run the viewing-angle probe every 25 frames: how many points' patch
view is no longer their host view, how many of those have a host view closer
in angle to the current camera than their patch view, and the mean angle
between a point's patch view and the current camera's view of it.  The
reference's figures (``artifacts/patch_source_ab.json``) stand beside them,
and the card's name and power limit.

    python -m hso_tpu_torch.tools.ab_patch_source [n=300]
        [out=artifacts/patch_source_ab_torch.json] [cpu=1]
"""

from __future__ import annotations

import datetime
import json
import os
import sys

import numpy as np

from hso_tpu_torch.bench import ATE_GATE_M, ROOT, bench_camera, bench_scene, render_frames
from hso_tpu_torch.config import Config
from hso_tpu_torch.math import se3np
from hso_tpu_torch.pipeline.scan import pin_float32_matmul
from hso_tpu_torch.tools.make_hard_artifact import (beside, device_of, hardware,
                                                    load_reference, run_handler)

PROBE_EVERY = 25


def pendulum_trajectory(n: int) -> list:
    """Wide lateral sweep with a slow period and yaw: revisits early
    viewpoints from frame ≈ n/2 on, twice a period."""
    poses = []
    for k in range(n):
        t = k / 18.0
        xi = np.r_[
            1.3 * np.sin(0.35 * t),            # wide, slow lateral pendulum
            0.10 * np.sin(0.9 * t),
            0.15 * np.sin(0.25 * t),
            0.03 * np.sin(0.7 * t),
            -0.22 * np.sin(0.35 * t),          # yaw swinging with the sweep
            0.02 * np.sin(0.5 * t),
        ]
        poses.append(se3np.exp(xi))
    return poses


def _angle_deg(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    cos = np.sum(a * b, -1) / np.maximum(np.linalg.norm(a, axis=-1)
                                         * np.linalg.norm(b, axis=-1), 1e-12)
    return np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))


def viewing_angles(vo) -> dict:
    """The probe on the handler's current map: points whose patch view is not
    their host view (``diverged``), those among them whose host view is closer
    in angle to the current camera (``host_wins``), and the mean angle between
    each point's patch view and the current view of it."""
    pts = vo.points
    valid = pts.valid
    if not valid.any() or vo.last_frame is None:
        return dict(points=0, diverged=0, host_wins=0, mean_patch_angle_deg=None)
    p = pts.positions(vo.kfs.poses)[valid]

    def centre(T):
        return se3np.translation(se3np.inv(T))

    c_host = centre(vo.kfs.poses[pts.host_kf[valid]])
    c_patch = centre(vo.kfs.poses[pts.patch_kf[valid]])
    c_cur = centre(vo.last_frame.T_f_w)[None]
    a_patch = _angle_deg(p - c_patch, p - c_cur)
    a_host = _angle_deg(p - c_host, p - c_cur)
    div = pts.patch_kf[valid] != pts.host_kf[valid]
    return dict(points=int(valid.sum()), diverged=int(div.sum()),
                host_wins=int((div & (a_host < a_patch)).sum()),
                mean_patch_angle_deg=float(a_patch.mean()))


def main(argv=None) -> int:
    args = dict(a.split("=", 1) for a in (sys.argv[1:] if argv is None else argv) if "=" in a)
    device = device_of(args, "ab_patch_source")
    if device is None:
        return 2
    pin_float32_matmul()
    n = int(args.get("n", 300))
    out_path = args.get("out", os.path.join(ROOT, "artifacts", "patch_source_ab_torch.json"))
    ref = load_reference("patch_source_ab.json")

    cam = bench_camera()
    poses = pendulum_trajectory(n)
    print(f"rendering {n} frames ...", file=sys.stderr)
    frames = render_frames(bench_scene(cam), poses)

    results, probe = [], []

    def on_frame(k, vo):
        if k and k % PROBE_EVERY == 0:
            probe.append(dict(frame=k, **viewing_angles(vo)))

    for i, mode in enumerate(("recency", "closest")):
        run = run_handler(cam, Config(patch_source=mode), frames, poses, device,
                          on_frame=on_frame if mode == "recency" else None)
        run.pop("handler")
        run.pop("n_reloc_entries")
        run.pop("n_points_final")
        m = run.pop("matches")
        run.update(mean_matches=float(np.mean(m)), p10_matches=int(np.percentile(m, 10)))
        results.append(dict(patch_source=mode, **run, **beside(
            run, ref["results"][i] if ref else None, keys=("ate_rmse_m", "mean_matches"))))
        print(json.dumps(results[-1]), file=sys.stderr)

    doc = {
        "trajectory": "pendulum (wide lateral sweep + yaw, revisits early viewpoints)",
        "protocol": "python -m hso_tpu_torch.tools.ab_patch_source (FrameHandler.add_image "
                    "from frame 0); reference: artifacts/patch_source_ab.json",
        "n_frames": n,
        "hardware": hardware(device),
        "date": datetime.date.today().isoformat(),
        "results": results,
        "viewing_angle_probe": {
            "description": f"every {PROBE_EVERY} frames of the recency run: points whose "
                           "patch view is not their host view (diverged), those whose host "
                           "view is angularly closer to the current camera than their "
                           "patch view (host_wins), the mean patch viewing angle",
            "rows": probe,
        },
        "closest_minus_recency_ate_m": results[1]["ate_rmse_m"] - results[0]["ate_rmse_m"],
        "bars": {"n_failed_frames": 0, "ate_rmse_m_below": ATE_GATE_M},
        "bars_met": all(r["n_failed_frames"] == 0 and r["ate_rmse_m"] < ATE_GATE_M
                        for r in results),
    }
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as fh:
        json.dump(doc, fh, indent=1)
    print(json.dumps(results))
    return 0 if doc["bars_met"] else 1


if __name__ == "__main__":
    sys.exit(main())

"""The boxseq-2200 accuracy and determinism bar, run on the port.

Run from the repository root, after writing the sequence with
``python -m hso_tpu_torch.tools.make_synthetic_dataset out=<dir>``:

    python -m hso_tpu_torch.tools.boxseq_multirun data=<dir> [n_runs=5]
        [out=artifacts/boxseq_2200_ate_torch.json] [device=cuda|cpu]

Runs the synchronous ``FrameHandler.add_image`` over the whole sequence
``n_runs`` times in one process (each run a fresh handler, images read from
disk inside the timed loop) and reports, per run, the scale-aligned ATE of
the keyframe trajectory against ground truth (RMSE and max excursion), the
keyframes, the failed frames and frames/s on the host clock; then whether
every run gave the same keyframe set and bitwise-equal keyframe positions.
The protocol is the JAX package's ``scripts/boxseq_multirun.py``; its result
on a TPU (``artifacts/boxseq_2200_ate.json``) is the reference's accuracy.
Writes one JSON file with the card's name and power limit under
``hardware``.  Runs on the GPU unless ``device=cpu``; without a GPU it exits 2.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from hso_tpu_torch.bench import card_line
from hso_tpu_torch.config import Config
from hso_tpu_torch.io.calib import parse_calib
from hso_tpu_torch.io.image_reader import ImageReader
from hso_tpu_torch.math import se3np
from hso_tpu_torch.pipeline.frame_handler import RESULT_FAILURE, FrameHandler
from hso_tpu_torch.pipeline.scan import pin_float32_matmul
from hso_tpu_torch.utils.evaluate import ate

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_once(reader, cam, gt_xyz, device) -> dict:
    """One run over the whole sequence; the keyframe trajectory's ATE (keyframe
    timestamps are frame indices into the ground truth)."""
    vo = FrameHandler(cam, Config(), device=device)
    n_fail = 0
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for i in range(len(reader)):
        res = vo.add_image(reader.read_image(i), ts=float(i))
        n_fail += res.status == RESULT_FAILURE
    sync()
    wall = time.perf_counter() - t0
    kf_ts = [kf.timestamp for kf in vo.kfs.frames]
    kf_xyz = np.stack([se3np.translation(se3np.inv(kf.T_f_w)) for kf in vo.kfs.frames])
    r = ate(kf_xyz, gt_xyz[np.asarray(kf_ts, int)], with_scale=True)
    return {"ate_rmse_m": float(r.rmse), "ate_max_m": float(r.max), "scale": float(r.scale),
            "n_keyframes": len(kf_ts), "n_failures": int(n_fail),
            "fps": len(reader) / wall, "seconds": wall, "kf_xyz": kf_xyz, "kf_ts": kf_ts}


def stats(xs) -> dict:
    return {"median": float(np.median(xs)), "min": float(np.min(xs)), "max": float(np.max(xs))}


def main(argv=None) -> int:
    args = dict(a.split("=", 1) for a in (sys.argv[1:] if argv is None else argv) if "=" in a)
    data = args.get("data", os.path.join(tempfile.gettempdir(), "boxseq2200"))
    n_runs = int(args.get("n_runs", 5))
    out_path = args.get("out", os.path.join(ROOT, "artifacts", "boxseq_2200_ate_torch.json"))
    device = torch.device(args.get("device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        print("boxseq_multirun: no CUDA device (torch.cuda.is_available() is False); "
              "pass device=cpu to run on the CPU", file=sys.stderr)
        return 2
    pin_float32_matmul()

    cam = parse_calib(os.path.join(data, "calib.txt"))
    reader = ImageReader(os.path.join(data, "images"), (cam.width, cam.height),
                         os.path.join(data, "times.txt"))
    gt_xyz = np.loadtxt(os.path.join(data, "groundtruth.txt"))[:, 1:4]

    runs = []
    for k in range(n_runs):
        r = run_once(reader, cam, gt_xyz, device)
        print(f"run {k}: rmse={r['ate_rmse_m'] * 1e3:.3f} mm max={r['ate_max_m'] * 1e3:.3f} mm "
              f"kfs={r['n_keyframes']} fail={r['n_failures']} fps={r['fps']:.2f}",
              file=sys.stderr, flush=True)
        runs.append(r)

    base = runs[0]
    identical = all(
        r["kf_ts"] == base["kf_ts"] and r["kf_xyz"].shape == base["kf_xyz"].shape
        and np.array_equal(r["kf_xyz"], base["kf_xyz"])
        for r in runs[1:])
    doc = {
        "sequence": os.path.basename(os.path.normpath(data)),
        "protocol": f"{n_runs} full runs of the synchronous FrameHandler.add_image in one "
                    "process (python -m hso_tpu_torch.tools.boxseq_multirun); keyframe "
                    "trajectory, scale-aligned ATE; run-to-run identity tested bitwise",
        "n_frames": len(reader),
        "n_runs": n_runs,
        "runs_identical_bitwise": bool(identical),
        "ate_rmse_m": stats([r["ate_rmse_m"] for r in runs]),
        "ate_max_excursion_m": stats([r["ate_max_m"] for r in runs]),
        "scale": [r["scale"] for r in runs],
        "n_keyframes": [r["n_keyframes"] for r in runs],
        "n_failures": [r["n_failures"] for r in runs],
        "host_loop_fps": [r["fps"] for r in runs],
        "seconds_per_run": [r["seconds"] for r in runs],
        "hardware": card_line() if device.type == "cuda" else "cpu",
        "device": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
        "torch": torch.__version__,
        "date": time.strftime("%Y-%m-%d"),
    }
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(doc, f, indent=1)
    print(json.dumps(doc, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

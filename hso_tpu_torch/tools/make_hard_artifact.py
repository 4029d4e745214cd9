"""The hard box sequence: photometric torture with calibration off and on.

The port's counterpart of the JAX package's ``scripts/make_hard_artifact.py``.
The bench's box sequence is rendered, corrupted by the torture chain
(:mod:`hso_tpu_torch.tools.torture`: gamma response, vignette, exposure walk
with flicker, read and shot noise, motion blur, a moving occluder) at two
levels, and each level runs through ``FrameHandler.add_image`` twice: online
photometric calibration off and on (``solve_every = min_frames = 8``, the
reference's settings).  The artifact records the scale-aligned ATE RMSE of
every frame after the bootstrap's first ten, failed frames, relocalization
entries, the final stage and map size, with the reference's figures
(``artifacts/boxseq_hard.json``) beside each run and the card's name and
power limit.

    python -m hso_tpu_torch.tools.make_hard_artifact [n=400]
        [out=artifacts/boxseq_hard_torch.json] [cpu=1]

Runs on the GPU; ``cpu=1`` runs on the CPU, and without a GPU it exits 2
unless ``cpu=1`` is given.  The helpers here (:func:`device_of`,
:func:`run_handler`, :func:`tracked_ate`, :func:`beside`) serve the other
validation drivers too.
"""

from __future__ import annotations

import datetime
import json
import os
import sys
import time

import numpy as np
import torch

from hso_tpu_torch.bench import (ATE_GATE_M, ROOT, bench_camera, bench_scene, card_line,
                                 render_frames, trajectory)
from hso_tpu_torch.config import Config
from hso_tpu_torch.math import se3np
from hso_tpu_torch.pipeline.frame_handler import RESULT_FAILURE, FrameHandler
from hso_tpu_torch.pipeline.scan import pin_float32_matmul
from hso_tpu_torch.tools.torture import LEVELS, Torture, image_velocities
from hso_tpu_torch.utils.evaluate import ate

#: frames after the start that the ATE leaves out (the bootstrap), as the reference
ATE_SKIP = 10


def device_of(args: dict, name: str):
    """The run's device from the ``cpu=`` argument: the card unless asked;
    None (after a message) when there is no card and the CPU was not asked."""
    if int(args.get("cpu", "0")):
        return torch.device("cpu")
    if not torch.cuda.is_available():
        print(f"{name}: no CUDA device (torch.cuda.is_available() is False); pass cpu=1 "
              "to run on the CPU", file=sys.stderr)
        return None
    return torch.device("cuda")


def hardware(device) -> dict:
    """What the run ran on: the card's name and power limit as nvidia-smi gives
    them, or the CPU."""
    doc = {"device": str(device), "torch": torch.__version__}
    if device.type == "cuda":
        doc.update(card=card_line(), kind=torch.cuda.get_device_name(0),
                   cuda=torch.version.cuda)
    return doc


def tracked_ate(vo, poses) -> float:
    """Scale-aligned ATE RMSE (m) of the handler's trajectory against the
    ground-truth poses (world→camera), past the first ``ATE_SKIP`` frames."""
    est = np.stack([se3np.translation(se3np.inv(se3np.normalize(T))) for _, T in vo.trajectory])
    gt = np.stack([se3np.translation(se3np.inv(T)) for T in poses])
    return float(ate(est[ATE_SKIP:], gt[ATE_SKIP:], with_scale=True).rmse)


def run_handler(cam, cfg, frames, poses, device, photo_every: int = 0, on_frame=None) -> dict:
    """``FrameHandler.add_image`` over ``frames``; with ``photo_every`` the
    calibrator solves every that many frames from that many on.  Returns the
    handler and its figures: ATE, failures, relocalization entries, matches
    of the tracked frames, final stage, points, seconds (synchronised)."""
    vo = FrameHandler(cam, cfg, device=device)
    if photo_every:
        vo.photo.solve_every = photo_every
        vo.photo.min_frames = photo_every
    n_fail = n_reloc = 0
    matches = []
    t0 = time.perf_counter()
    for k, img in enumerate(frames):
        res = vo.add_image(img, ts=float(k))
        if res.status == RESULT_FAILURE:
            n_fail += 1
            n_reloc += vo.stage != "default"
        elif vo.stage == "default" and res.n_matches:
            matches.append(res.n_matches)
        if on_frame is not None:
            on_frame(k, vo)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    return dict(handler=vo, ate_rmse_m=tracked_ate(vo, poses), n_failed_frames=n_fail,
                n_reloc_entries=n_reloc, matches=matches, final_stage=vo.stage,
                n_points_final=int(vo.points.valid.sum()), wall_s=wall,
                frames_per_s=len(frames) / wall)


def beside(ours: dict, ref: dict | None, keys=("ate_rmse_m",)) -> dict:
    """The reference's figures beside the port's, with the ratio of each and
    whether it is above 2 (a finding, not a failure)."""
    if ref is None:
        return {"reference": None}
    doc = {"reference": ref}
    for k in keys:
        if ref.get(k):
            doc[f"{k}_over_reference"] = ours[k] / ref[k]
            doc[f"{k}_above_2x_reference"] = ours[k] > 2.0 * ref[k]
    return doc


def load_reference(name: str):
    path = os.path.join(ROOT, "artifacts", name)
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        return json.load(fh)


def main(argv=None) -> int:
    args = dict(a.split("=", 1) for a in (sys.argv[1:] if argv is None else argv) if "=" in a)
    device = device_of(args, "make_hard_artifact")
    if device is None:
        return 2
    pin_float32_matmul()
    n = int(args.get("n", 400))
    out_path = args.get("out", os.path.join(ROOT, "artifacts", "boxseq_hard_torch.json"))
    ref_doc = load_reference("boxseq_hard.json")

    cam = bench_camera()
    poses = trajectory(n)
    print(f"rendering {n} clean frames ...", file=sys.stderr)
    clean = render_frames(bench_scene(cam), poses)
    vels = image_velocities(cam, poses)

    levels = {}
    for level in ("hard", "extreme"):
        torture = Torture(cam, n, level)
        frames = [torture(img, k, vels[k]) for k, img in enumerate(clean)]
        results = []
        for i, photo in enumerate((False, True)):
            print(f"running {level}, photometric calibration {'on' if photo else 'off'} ...",
                  file=sys.stderr)
            run = run_handler(cam, Config(photometric_calib=photo), frames, poses, device,
                              photo_every=8 if photo else 0)
            run.pop("handler")
            run.pop("matches")
            ref = ref_doc["levels"][level]["results"][i] if ref_doc else None
            results.append(dict(photometric_calib=photo, **run, **beside(run, ref)))
            print(json.dumps(results[-1]), file=sys.stderr)
        levels[level] = {
            "torture": dict(LEVELS[level],
                            exposure_range_log=[float(torture.log_e.min()),
                                                float(torture.log_e.max())],
                            noise="gauss sigma=2 + shot sigma=sqrt(I/16)",
                            motion_blur="directional, up to 7 px",
                            occluder="90x110 textured patch, orbiting"),
            "results": results,
        }
    runs = [r for lv in levels.values() for r in lv["results"]]
    doc = {
        "sequence": "boxseq_hard",
        "protocol": "python -m hso_tpu_torch.tools.make_hard_artifact (FrameHandler.add_image "
                    "from frame 0; scale-aligned ATE of every frame past the first "
                    f"{ATE_SKIP}); reference: artifacts/boxseq_hard.json",
        "n_frames": n,
        "hardware": hardware(device),
        "date": datetime.date.today().isoformat(),
        "bars": {"n_failed_frames": 0, "ate_rmse_m_below": ATE_GATE_M},
        "bars_met": all(r["n_failed_frames"] == 0 and r["ate_rmse_m"] < ATE_GATE_M
                        for r in runs),
        "levels": levels,
    }
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as fh:
        json.dump(doc, fh, indent=1)
    print(json.dumps({k: [{kk: r[kk] for kk in ("photometric_calib", "ate_rmse_m",
                                                 "n_failed_frames", "wall_s")}
                          for r in v["results"]] for k, v in levels.items()}))
    return 0 if doc["bars_met"] else 1


if __name__ == "__main__":
    sys.exit(main())

"""Reused activation rows and the BA's chi2 late in the evolving-map scan.

Run from the repository root:

    python3 -m hso_tpu_torch.tools.reused_rows [--frames 192] [--device cuda|cpu] [--out FILE]

The keyframe work activates converged seeds into a ring of ``R_RES`` point
rows.  Once the ring wraps, each activation takes a row that held a point.
The port empties the row's observation-ring cells (``ba_pack``); the JAX
bench does not (``bench.py:484-507`` write no ``ba_pack``), so there the new
point keeps the old point's measurements and the next BA holds it to them.

The tool runs the scan twice from ``artifacts/bench_boot.npz``: as the port
runs it, and with each event's activated rows given back the cells they held
when the event began (a wrapper around ``keyframe_work`` here, as the bench
would keep them but for this frame's registration and the BA's inlier bits).
The wrapper reads each event's figures on the host, so it is the scan's
keyframe body eagerly (the step's ``keyframe_body``), not a captured graph.
It prints one JSON object: per keyframe event the activations, the rows that
held a valid point before (reused), the observation cells those rows held,
and BA chi2 init/final, for both runs; and the ATE of both runs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def watched(keyframe, log: list, keep_old_cells: bool, cam, cfg):
    """The scan's keyframe body, ``keyframe_work`` for ``cam``/``cfg``, that
    logs each event's activations and, with ``keep_old_cells``, gives the rows
    it activated into back the observation cells they held when the event
    began."""
    R_RES = keyframe.R_RES

    def kf_work(st, seeds, out):
        st2, seeds2, chk, stats = keyframe.keyframe_work(st, seeds, out, cam, cfg)
        dev = st["light"].device
        p0 = st["light"].shape[0] - R_RES - 1
        n_act = int(stats["activated"])
        tgt = p0 + torch.remainder(st["cursor"].to(torch.int64)
                                   + torch.arange(n_act, device=dev), R_RES)
        log.append(dict(kf_idx=int(st["kf_count"]), activated=n_act,
                        reused=int((st["light"][tgt] >= 8).sum()),
                        old_cells=int((st["ba_pack"][tgt, :, 6] > 0.5).sum()),
                        chi2_init=float(stats["chi2_init"]),
                        chi2_final=float(stats["chi2_final"]),
                        ba_points=int(stats["ba_points"])))
        if keep_old_cells:
            st2 = dict(st2)
            st2["ba_pack"] = st2["ba_pack"].clone()
            st2["ba_pack"][tgt] = st["ba_pack"][tgt]
        return st2, seeds2, chk, stats

    return kf_work


def main() -> int:
    from hso_tpu_torch.bench import (BOOT_NPZ, bench_camera, bench_scene, card_line,
                                     render_frames, scan_ate, trajectory)
    from hso_tpu_torch.config import Config
    from hso_tpu_torch.pipeline import keyframe, scan
    from hso_tpu_torch.utils import checkpoint

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=192)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("reused_rows: no CUDA device (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return 2
    cam, cfg = bench_camera(), Config()
    carry0, meta = checkpoint.scan_state_from_checkpoint(BOOT_NPZ, cam, cfg, device)
    start = meta["frame_count"]
    gt = trajectory(start + args.frames)[start:]
    frames = torch.as_tensor(render_frames(bench_scene(cam), gt)).to(device)
    step = scan.make_scan_step(cam, cfg, device)
    doc = {"card": card_line() if device.type == "cuda" else "cpu", "frames": args.frames}
    for name, keep in (("port", False), ("old_cells_kept", True)):
        log = []
        step.keyframe_body = watched(keyframe, log, keep, cam, cfg)
        res = scan.run_scan(step, carry0, frames, cam, cfg, meta["px_error_angle"])
        doc[name] = dict(events=log, ate_rmse_m=scan_ate(res["traj"].cpu().numpy(), gt),
                         min_inliers=int(res["n_inliers"].min()))
    text = json.dumps(doc)
    print(text, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

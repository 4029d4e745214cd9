"""Stage ablation of the composed per-frame step: what each stage costs
inside the whole step.

The port's counterpart of the JAX package's ``scripts/profile_ablate.py``.
One stage at a time is replaced by a stub, at the level of the names
``pipeline/fused_step.py`` calls (``update_seeds``, ``match_points``,
``make_coarse_tracker``, ``optimize_pose``, ``select_candidates``; with
``build_frame_pyramids`` the six names restored afterwards), the step is
rebuilt (``pipeline/scan.py::make_scan_step`` with ``graph=False``: the
eager step, launch by launch; the coarse trackers are made when the step is
built), and ``frames`` frames run through it.  Each stub
keeps the real function's contract (keys, shapes, dtypes, device) and makes
no host copy; the coarse stub returns ``T_init`` and ``a_init`` for both the
FC and the IC tracker.

The JAX script's set-up: the bench camera, scene and trajectory;
``FrameHandler`` resumed from ``artifacts/bench_boot.npz`` at
``resume_stage="default"``; the map snapshot frozen; the pose, pyramid and
its statistics, exposure, tracking reference, seeds and counters carried from
frame to frame; a checksum of ``T_new``, ``grad_mean``, ``seeds["mu"]·1e-9``,
``packed[13]`` and ``packed[15]`` that every variant computes.  Its seven
variants, in its order: ``full``, ``-update_seeds``, ``-match_points``,
``-coarse_track``, ``-pose_opt``, ``-select``, ``-seeds-match-track-pose``.

    python -m hso_tpu_torch.tools.profile_ablate [frames=64] [reps=3] [cpu=1] [out=FILE]

Prints the JAX script's line per variant (``name: ms/frame (marginal ±x)``),
then one JSON line per variant: host ms a frame (host clock around the frames,
synchronised at the end; the median of ``reps``, the variants in turns within
each repetition), and on the card device-busy ms and device kernels a frame
(``torch.profiler`` over a first, untimed pass) and the wrappers' launches of
K1–K6 a frame; each as a marginal against ``full`` (``full`` − variant: what the
stage costs).  ``full`` must give the unpatched step's bits.  ``cpu=1`` runs
the same on the CPU (the kernels' plain versions; the device figures "not
measured").  Without a GPU it exits 2 unless ``cpu=1`` is given.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import sys
import time

import numpy as np
import torch

from hso_tpu_torch.bench import BOOT_NPZ, bench_camera, bench_scene, trajectory
from hso_tpu_torch.config import Config
from hso_tpu_torch.image.pyramid import build_frame_pyramids
from hso_tpu_torch.math import se3np
from hso_tpu_torch.ops import align_cuda, epipolar_cuda, window_cuda
from hso_tpu_torch.pipeline import fused_step
from hso_tpu_torch.pipeline.frame_handler import FrameHandler
from hso_tpu_torch.pipeline.scan import make_scan_step, pin_float32_matmul
from hso_tpu_torch.track import coarse_cuda, pose_cuda
from hso_tpu_torch.utils.checkpoint import load_checkpoint

N_SCAN = 64
N_REP = 3
#: the names of ``fused_step`` an ablation may replace, restored after each
STAGE_NAMES = ("update_seeds", "match_points", "make_coarse_tracker", "optimize_pose",
               "select_candidates", "build_frame_pyramids")
#: the wrappers' launch counters of K1–K6
KERNEL_COUNTERS = {"extract_windows": window_cuda, "pack_level_windows": window_cuda,
                   "coarse_level_ic": coarse_cuda, "align_match": align_cuda,
                   "pose_lm": pose_cuda, "zmncc_line_scores": epipolar_cuda}


# ------------------------------------------------------------------ stubs
def stub_update_seeds(seeds, host_T_w, host_exposure, cur_pyr, cur_sobel_x, cur_sobel_y,
                      T_cur_w, cur_exposure, px_error_angle, cam, update_mask=None,
                      n_levels: int = 3):
    dev = seeds["valid"].device
    s = seeds["valid"].shape[0]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return seeds, {"n_visible": zero, "n_updated": zero,
                   "px_match": torch.zeros((s, 2), dtype=torch.float32, device=dev),
                   "matched": torch.zeros((s,), dtype=torch.bool, device=dev)}


def stub_match_points(cand, cur_pyr, cur_sobel_x, cur_sobel_y, T_cur_w, exposure_cur, cam,
                      n_levels: int = 3, edgelet_cos_angle: float = 0.86,
                      align_max_iter: int = 10):
    valid = cand["valid"]
    n, dev = valid.shape[0], valid.device
    return {"px": torch.zeros((n, 2), dtype=torch.float32, device=dev),
            "level": torch.zeros((n,), dtype=torch.int32, device=dev),
            "f_cur": torch.zeros((n, 3), dtype=torch.float32, device=dev),
            "success": valid,
            "grad_cur": torch.zeros((n, 2), dtype=torch.float32, device=dev)}


def stub_make_coarse_tracker(cam, max_level: int = 4, min_level: int = 1, n_iter: int = 30,
                             inverse: bool = False, pattern_offset: int = 2, device="cuda"):
    device = torch.device(device)
    n_levels = max_level - min_level + 1

    def track(ref_pyr, cur_pyr, px_ref, f_ref, dist_ref, T_cur_ref, a_init):
        return {"T_cur_ref": torch.as_tensor(T_cur_ref, dtype=torch.float32, device=device),
                "exposure_ratio": torch.as_tensor(a_init, dtype=torch.float32,
                                                  device=device).reshape(()),
                "n_tracked": torch.zeros((), dtype=torch.int32, device=device),
                "energy": torch.zeros((), dtype=torch.float32, device=device),
                "n_iters": torch.zeros((n_levels,), dtype=torch.int32, device=device)}

    return track


def stub_optimize_pose(T_f_w, p_world, f_obs, level, grad, is_edgelet, is_temporary, valid,
                       focal: float = 450.0, reproj_thresh: float = 2.0, n_iter: int = 12):
    dev = valid.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return {"T_f_w": T_f_w.to(torch.float32), "inlier": valid,
            "n_inliers": torch.sum(valid.to(torch.int32)), "err_init_px": zero,
            "err_final_px": zero, "scale_px": zero,
            "cov": torch.zeros((6, 6), dtype=torch.float32, device=dev),
            "error_weight": torch.ones((), dtype=torch.float32, device=dev)}


def stub_select_candidates(pos_w, valid, priority, T_cur_w, cam, cell: int = 36,
                           grid_h: int = 14, grid_w: int = 21, n_types: int = 8):
    c, dev = grid_h * grid_w, pos_w.device
    point = torch.zeros((c,), dtype=torch.int32, device=dev)
    none = torch.zeros((c,), dtype=torch.bool, device=dev)
    px = torch.zeros((c, 2), dtype=torch.float32, device=dev)
    return {"cell_point": point, "cell_valid": none, "cell_px": px, "cell_point2": point,
            "cell_valid2": none, "cell_px2": px,
            "n_projected": torch.zeros((), dtype=torch.int64, device=dev)}


VARIANTS = (
    ("full", {}),
    ("-update_seeds", {"update_seeds": stub_update_seeds}),
    ("-match_points", {"match_points": stub_match_points}),
    ("-coarse_track", {"make_coarse_tracker": stub_make_coarse_tracker}),
    ("-pose_opt", {"optimize_pose": stub_optimize_pose}),
    ("-select", {"select_candidates": stub_select_candidates}),
    ("-seeds-match-track-pose", {
        "update_seeds": stub_update_seeds, "match_points": stub_match_points,
        "make_coarse_tracker": stub_make_coarse_tracker,
        "optimize_pose": stub_optimize_pose}),
)


@contextlib.contextmanager
def patched(patches: dict):
    """``fused_step``'s names replaced by ``patches``; every name of
    ``STAGE_NAMES`` is the object it was before, afterwards."""
    old = {k: getattr(fused_step, k) for k in STAGE_NAMES}
    for k, v in patches.items():
        setattr(fused_step, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(fused_step, k, v)


# ------------------------------------------------------------------ the run
class Resumed:
    """The resumed state every variant starts from, on ``device``."""

    def __init__(self, device, n_frames: int):
        self.device = device = torch.device(device)
        self.cam, self.cfg = bench_camera(), Config()
        scene = bench_scene(self.cam)
        vo = FrameHandler(self.cam, self.cfg, device=device)
        load_checkpoint(vo, BOOT_NPZ, resume_stage="default")
        start = vo.frame_count
        frames = [scene.render(T) for T in trajectory(start + n_frames + 1)[start:]]
        last = vo.last_frame
        self.snap = vo._snapshot()
        self.seeds0 = vo.seeds
        self.obs0 = vo._prev_obs_dev(last)
        self.px_err = vo._px_error_dev()
        self.T0 = torch.as_tensor(last.T_f_w, dtype=torch.float32, device=device)
        self.pyr0 = build_frame_pyramids(frames[0], device=device)["pyr"]
        self.I_rel = torch.as_tensor(se3np.identity().astype(np.float32), device=device)
        self.imgs = torch.as_tensor(np.stack(frames[1:n_frames + 1]), device=device)
        self.n_points = vo.points.p_max

        def scalar(x):
            return torch.full((), x, dtype=torch.float32, device=device)

        # the JAX script's starting statistics
        self.grad_mean0, self.intensity0, self.exposure0 = scalar(10.0), scalar(128.0), scalar(1.0)

    def step(self):
        """The whole eager step as ``fused_step``'s names stand now (the
        ablation measures the eager step, launch by launch)."""
        return make_scan_step(self.cam, self.cfg, self.device, graph=False)

    def run(self, step, n: int):
        """``n`` frames through ``step``; returns (checksum, trajectory)."""
        T, pyr, gm, it, exp = self.T0, self.pyr0, self.grad_mean0, self.intensity0, self.exposure0
        obs, seeds = self.obs0, self.seeds0
        acc = torch.zeros((2, self.n_points), dtype=torch.int32, device=self.device)
        chks, traj = [], []
        for i in range(n):
            out = step(self.imgs[i], pyr, gm, T, obs, it, exp, self.I_rel, self.snap, seeds,
                       self.px_err, acc)
            d = out["data"]
            T, pyr, gm, it, exp = (out["T_new"], d["pyr"], d["grad_mean"],
                                   d["intensity_mean"], out["exposure"])
            obs, seeds, acc = out["obs_next"], out["seeds"], out["acc"]
            # state every variant still computes each frame
            chks.append(torch.sum(T) + torch.sum(gm) + torch.sum(seeds["mu"]) * 1e-9
                        + out["packed"][13] + out["packed"][15])
            traj.append(T)
        return torch.sum(torch.stack(chks)) + torch.sum(seeds["mu"]), torch.stack(traj)


def read_launches() -> dict:
    return {k: m.LAUNCHES[k] for k, m in KERNEL_COUNTERS.items()}


def profile_pass(res: Resumed, step, n: int) -> tuple:
    """One pass under ``torch.profiler``: (checksum, trajectory, dict of
    device-busy ms, device kernels and the wrappers' launches a frame)."""
    from torch.profiler import ProfilerActivity, profile

    from hso_tpu_torch.tools.profile_update_seeds import device_activity

    before = read_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        chk, traj = res.run(step, n)
        torch.cuda.synchronize(res.device)
    launches = {k: (v - before[k]) / n for k, v in read_launches().items()}
    events = device_activity(prof)
    if not events:
        return chk, traj, {"device_busy_ms_per_frame": "not measured: the profiler reported "
                           "no device time", "launches_per_frame": launches}
    return chk, traj, {"device_busy_ms_per_frame": sum(us for _, us in events) / 1e3 / n,
                       "device_kernels_per_frame": len(events) / n,
                       "launches_per_frame": launches}


def ablate(device="cuda", frames: int = N_SCAN, reps: int = N_REP) -> dict:
    """Every variant over ``frames`` frames; returns the header and one row a
    variant (see the module's docstring).  Raises if ``full`` does not give the
    unpatched step's bits or a name of ``fused_step`` is not restored."""
    pin_float32_matmul()
    res = Resumed(device, frames)
    on_card = res.device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(res.device)) if on_card else (lambda: None)
    originals = {k: getattr(fused_step, k) for k in STAGE_NAMES}
    _, traj_unpatched = res.run(res.step(), frames)

    rows = {name: {"variant": name, "stubbed": sorted(p)} for name, p in VARIANTS}
    for name, patches in VARIANTS:     # every variant once, untimed (on the card profiled)
        with patched(patches):
            if on_card:
                chk, traj, prof = profile_pass(res, res.step(), frames)
                rows[name].update(prof)
            else:
                chk, traj = res.run(res.step(), frames)
                rows[name].update(device_busy_ms_per_frame="not measured (CPU run)",
                                  device_kernels_per_frame="not measured (CPU run)")
        rows[name]["checksum"] = float(chk)
        if name == "full":
            assert torch.equal(traj, traj_unpatched), "full: not the unpatched step's bits"
    host = {name: [] for name, _ in VARIANTS}
    for _ in range(reps):                       # the variants in turns within a repetition
        for name, patches in VARIANTS:
            with patched(patches):
                step = res.step()
                sync()
                t0 = time.perf_counter()
                res.run(step, frames)
                sync()
            host[name].append((time.perf_counter() - t0) * 1e3 / frames)
    for name, _ in VARIANTS:
        rows[name].update(host_ms_per_frame=statistics.median(host[name]),
                          host_ms_per_frame_all=host[name])
    restored = all(getattr(fused_step, k) is v for k, v in originals.items())
    assert restored, "a name of fused_step was not restored"

    base = rows["full"]
    for row in rows.values():
        for key in ("host_ms_per_frame", "device_busy_ms_per_frame", "device_kernels_per_frame"):
            if isinstance(row.get(key), (int, float)):
                row[key.replace("_per_frame", "_marginal")] = base[key] - row[key]
        if "launches_per_frame" in row:
            row["launches_marginal"] = {k: base["launches_per_frame"][k] - v
                                        for k, v in row["launches_per_frame"].items()}
    head = {"frames": frames, "reps": reps, "device": str(res.device),
            "full_equals_unpatched": True, "names_restored": restored}
    return {"head": head, "rows": [rows[name] for name, _ in VARIANTS]}


def text_lines(doc: dict) -> list:
    """The JAX script's line per variant."""
    out = []
    base = doc["rows"][0]["host_ms_per_frame"]
    for i, row in enumerate(doc["rows"]):
        ms = row["host_ms_per_frame"]
        line = f"{row['variant']:>26s}: {ms:7.3f} ms/frame"
        out.append(line if i == 0 else f"{line}  (marginal {base - ms:+.3f})")
    return out


def main(argv=None) -> int:
    from hso_tpu_torch.tools.make_hard_artifact import device_of, hardware

    args = dict(a.split("=", 1) for a in (sys.argv[1:] if argv is None else argv) if "=" in a)
    device = device_of(args, "profile_ablate")
    if device is None:
        return 2
    doc = ablate(device, int(args.get("frames", N_SCAN)), int(args.get("reps", N_REP)))
    doc["head"].update(hardware(device))
    for line in text_lines(doc):
        print(line)
    print(json.dumps(doc["head"]))
    for row in doc["rows"]:
        print(json.dumps(row))
    if args.get("out"):
        with open(args["out"], "w") as fh:
            json.dump(doc, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

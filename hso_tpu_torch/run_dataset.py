"""Dataset runner: an image folder and a calibration file in, the TUM keyframe
trajectory out (the port's counterpart of the JAX package's
``scripts/run_dataset.py``, with the same ``key=value`` arguments).

    python -m hso_tpu_torch.run_dataset image=<dir> calib=<file> [times=<file>]
        [start=<n>] [end=<n>] [name=<result name>] [cpu=1] [photo=1]
        [trace=1] [gt=<file>] [max_dt=<s>] [ate_json=<file>] [live=<N>]
        [no_native=1]

Runs on the GPU; ``cpu=1`` runs on the CPU instead, and without a GPU the
runner exits 2 unless ``cpu=1`` is given.  Writes ``result/<name>.txt``
(``stamp tx ty tz qx qy qz qw``, camera-to-world, one line a keyframe; a
keyframe's stamp is its line of the ``times`` file).  ``photo=1`` turns on
online photometric calibration (response, vignette, exposure).
``trace=1`` writes per-frame stage timings to ``result/<name>_trace.csv`` and
prints the device's ten longest idle stretches, each with the host span that
was open as it began (``PerformanceMonitor.idle_gaps``).  It traces with
``fence=False``: no stage waits for the device, so the stages overlap the
device as they do untraced and the gaps are the program's own (a fenced
stage's wait would make gaps of its own).
``gt=<file>`` (TUM or EuRoC csv) prints the scale-aligned ATE of the keyframe
trajectory after the run; ``ate_json=<file>`` also writes it as JSON.
Calibrations that ask for whole-image undistortion are rectified on the
device (``undistort_remap`` and ``remap_bilinear``).  Frames are read by the
prefetching reader (:mod:`hso_tpu_torch.io.native_reader`: worker processes,
the same pixels as ``ImageReader``); ``no_native=1`` reads them in the loop
instead.  ``live=N`` refreshes ``result/live/{tracking,map}.png`` every N
frames (:mod:`hso_tpu_torch.utils.live_view`).
"""

from __future__ import annotations

import datetime
import json
import os
import sys
import time

import numpy as np
import torch

from hso_tpu_torch.bench import card_line
from hso_tpu_torch.config import Config
from hso_tpu_torch.image.pyramid import remap_bilinear
from hso_tpu_torch.io.calib import parse_calib
from hso_tpu_torch.io.image_reader import ImageReader
from hso_tpu_torch.io.native_reader import NativeImageReader
from hso_tpu_torch.io.trajectory import save_keyframe_trajectory
from hso_tpu_torch.pipeline.frame_handler import RESULT_FAILURE, FrameHandler
from hso_tpu_torch.pipeline.scan import pin_float32_matmul
from hso_tpu_torch.utils.evaluate import associate, ate, load_any, load_tum
from hso_tpu_torch.utils.live_view import LiveViewer

USAGE = __doc__.split("\n\n")[1]


class Undistorter:
    """Whole-image rectification on the device: the camera's remap tables
    uploaded once, each frame resampled bilinearly and truncated to uint8.
    On the card a frame goes up as a non-blocking copy from pinned memory, so
    the host does not wait for the device (as ``FrameHandler._h2d``)."""

    def __init__(self, cam, device):
        mx, my = cam.undistort_remap()
        self.device = torch.device(device)
        self.map_x = torch.from_numpy(mx).to(self.device)
        self.map_y = torch.from_numpy(my).to(self.device)

    def __call__(self, img: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.array(img, copy=True))
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return remap_bilinear(t, self.map_x, self.map_y).to(torch.uint8)


def make_handler(cam, device, photo: bool = False, trace_name: str | None = None,
                 trace_dir: str = "result"):
    """(handler, undistorter or None) for a calibration's camera: the handler
    runs the ideal pinhole of a camera whose images are rectified first."""
    undistort = None
    if getattr(cam, "undistort_image", False):
        undistort = Undistorter(cam, device)
        cam = cam.ideal()
    vo = FrameHandler(cam, Config(photometric_calib=photo), device=device)
    if trace_name is not None:
        vo.enable_tracing(trace_name=trace_name, trace_dir=trace_dir, fence=False)
    return vo, undistort


def run_frames(vo, reader, start: int, end: int, undistort=None, log=None, stream=None,
               viewer=None) -> dict:
    """``vo.add_image`` on frames ``start..end-1`` of ``reader``, each keyframe
    stamped with its line of the times file.  With ``stream`` (a
    :class:`~hso_tpu_torch.io.native_reader.NativeImageReader` over the same
    folder) the frames come from its prefetching workers; ``viewer`` (a
    :class:`~hso_tpu_torch.utils.live_view.LiveViewer`) sees every frame.
    Returns the failures, the per-frame results, the ms of each frame and the
    seconds of the run on the host clock (image reading included, as the JAX
    runner counts it)."""
    t0 = time.time()
    n_fail, results, frame_ms = 0, [], []
    frames = None
    if stream is not None:
        stream.start(start, end)
        frames = iter(stream)
    for i in range(start, end):
        t_frame = time.perf_counter()
        if frames is not None:
            j, img = next(frames)
            assert j == i, (j, i)
        else:
            img = reader.read_image(i)
        if undistort is not None:
            img = undistort(img)
        res = vo.add_image(img, ts=float(i))
        if viewer is not None:
            viewer.update(vo, img)
        if vo.last_frame is not None:
            vo.last_frame.stamp_str = reader.read_stamp(i)
        n_fail += res.status == RESULT_FAILURE
        results.append(res)
        frame_ms.append((time.perf_counter() - t_frame) * 1e3)
        if log is not None and (i - start) % 50 == 0:
            el = time.time() - t0
            log(f"[{i}/{end}] {res.status:12s} inl={res.n_inliers:3d} "
                f"kfs={len(vo.kfs.frames)} pts={int(vo.points.valid.sum())} "
                f"fps={max(i - start, 1) / el:.1f}")
    return dict(n_fail=n_fail, results=results, frame_ms=frame_ms, seconds=time.time() - t0)


def keyframe_ate(traj_path: str, gt_path: str, max_dt: float = 0.02):
    """(ATE of a TUM keyframe file against ground truth, associated pairs), or
    (None, pairs) below 3 pairs."""
    st_e, rows_e = load_tum(traj_path)
    st_g, xyz_g = load_any(gt_path)
    ia, ib = associate(st_e, st_g, max_dt=max_dt)
    if len(ia) < 3:
        return None, len(ia)
    return ate(rows_e[ia, :3], xyz_g[ib]), len(ia)


def main(argv=None) -> int:
    args = dict(a.split("=", 1) for a in (sys.argv[1:] if argv is None else argv) if "=" in a)
    if "image" not in args or "calib" not in args:
        print(USAGE)
        return 1
    cpu = bool(int(args.get("cpu", "0")))
    if not cpu and not torch.cuda.is_available():
        print("run_dataset: no CUDA device (torch.cuda.is_available() is False); "
              "pass cpu=1 to run on the CPU", file=sys.stderr)
        return 2
    device = torch.device("cpu" if cpu else "cuda")
    pin_float32_matmul()

    cam = parse_calib(args["calib"])
    reader = ImageReader(args["image"], (cam.width, cam.height), args.get("times"))
    start = int(args.get("start", 0))
    end = min(int(args.get("end", len(reader))), len(reader))
    name = args.get("name", "KeyFrameTrajectory")
    trace = bool(int(args.get("trace", "0")))
    vo, undistort = make_handler(cam, device, photo=bool(int(args.get("photo", "0"))),
                                 trace_name=f"{name}_trace" if trace else None)
    stream = None
    if not int(args.get("no_native", "0")):
        stream = NativeImageReader(args["image"], (cam.width, cam.height))
    viewer = None
    if int(args.get("live", "0")):
        viewer = LiveViewer(out_dir=os.path.join("result", "live"), every=int(args["live"]))
    try:
        run = run_frames(vo, reader, start, end, undistort, log=print, stream=stream,
                         viewer=viewer)
    finally:
        if stream is not None:
            stream.close()
    dt = run["seconds"]
    out = os.path.join("result", f"{name}.txt")
    n_kf = save_keyframe_trajectory(vo, out)
    print(f"done: {end - start} frames in {dt:.1f}s ({(end - start) / dt:.1f} fps), "
          f"{n_kf} keyframes -> {out}, {run['n_fail']} failures")
    if vo.monitor is not None:
        vo.monitor.close()
        print(f"trace -> {vo.monitor.path}")
        print("the device's ten longest idle stretches (ms, the host span as each began):")
        for s, span, t in vo.monitor.idle_gaps(10):
            print(f"  {1e3 * s:9.3f} ms  at {t:9.4f} s  {span}")
    if args.get("gt"):
        r, n_pairs = keyframe_ate(out, args["gt"], float(args.get("max_dt", 0.02)))
        if r is None:
            print(f"ATE: only {n_pairs} associated pairs — skipped")
            return 0
        print(r)
        if args.get("ate_json"):
            with open(args["ate_json"], "w") as fh:
                json.dump({
                    "sequence": args["image"],
                    "protocol": "python -m hso_tpu_torch.run_dataset (keyframe trajectory, "
                                "scale-aligned ATE against gt)",
                    "n_frames": end - start, "n_keyframes": n_kf,
                    "n_failures": run["n_fail"],
                    "ate_rmse_m": r.rmse, "ate_mean_m": r.mean, "ate_median_m": r.median,
                    "ate_max_m": r.max, "gt_pairs": n_pairs, "scale": r.scale,
                    "host_loop_fps": (end - start) / dt,
                    "hardware": "cpu" if cpu else card_line(),
                    "date": datetime.date.today().isoformat(),
                }, fh, indent=1)
            print(f"ate json -> {args['ate_json']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

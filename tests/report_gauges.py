"""Print the two rounding-sensitive directions found in the dataset path, on
the CPU, the port beside the JAX package (one JSON object):

* ``ba_free_scale``: the box sequence's first 24 frames through both
  handlers; for the BA of the keyframe event at frame 10 (keyframes 0-2,
  only keyframe 0 fixed), the median factor each side's BA applies to the
  points' inverse depths, and the factor between the two maps after it
  (min, max over the points).  ROADMAP §3.
* ``photometric_gauge``: the calibrator's solves of a 48-frame photometric
  run (the box sequence through ``testing.photo_distort``, ``solve_every`` =
  ``min_frames`` = 6), each solved again by the port at 1 and at 8 threads,
  with the points in another order, and by JAX: distances to the port at 1
  thread in log_e, c, the response curve over 3..252, v, rms_after, and in
  log_e modulo the common factor α (``testing.exposure_gauge``).

    JAX_PLATFORMS=cpu python tests/report_gauges.py      (~4 min)
"""

import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import conftest  # noqa: E402,F401  (JAX on the CPU)
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from hso_tpu.config import Config as JaxConfig  # noqa: E402
from hso_tpu.io.calib import parse_calib as jax_parse_calib  # noqa: E402
from hso_tpu.photometric.online_calib import solve_photometric as jax_solve  # noqa: E402
from hso_tpu.pipeline.frame_handler import FrameHandler as JaxHandler  # noqa: E402
from hso_tpu_torch import run_dataset, testing  # noqa: E402
from hso_tpu_torch.io.calib import parse_calib  # noqa: E402
from hso_tpu_torch.io.image_reader import ImageReader, write_png  # noqa: E402
from hso_tpu_torch.photometric import online_calib  # noqa: E402
from hso_tpu_torch.pipeline.frame_handler import FrameHandler  # noqa: E402
from hso_tpu_torch.pipeline.scan import pin_float32_matmul  # noqa: E402
from hso_tpu_torch.tools import make_synthetic_dataset as gen  # noqa: E402


def ba_free_scale(data: str) -> dict:
    logs = {}

    def record(cls, key):
        orig = cls._run_ba

        def run_ba(self, center):
            before, valid = self.points.idist.copy(), self.points.valid.copy()
            orig(self, center)
            logs.setdefault(key, []).append((self.frame_count, valid, before,
                                             self.points.idist.copy()))
        cls._run_ba = run_ba
        return orig

    orig_t, orig_j = record(FrameHandler, "port"), record(JaxHandler, "jax")
    try:
        reader = ImageReader(os.path.join(data, "images"), (640, 480))
        hj = JaxHandler(jax_parse_calib(os.path.join(data, "calib.txt")), JaxConfig())
        ht = FrameHandler(parse_calib(os.path.join(data, "calib.txt")), device="cpu")
        for i in range(24):
            img = reader.read_image(i)
            hj.add_image(img, ts=float(i))
            ht.add_image(img, ts=float(i))
    finally:
        FrameHandler._run_ba, JaxHandler._run_ba = orig_t, orig_j
    doc = {}
    for key, runs in logs.items():
        frame, valid, before, after = runs[0]
        doc[f"{key}_ba_factor_median"] = float(np.median(after[valid] / before[valid]))
        doc["frame"] = frame
    _, valid, _, after_t = logs["port"][0]
    ratio = after_t[valid] / logs["jax"][0][3][valid]
    doc["port_over_jax_after"] = [float(ratio.min()), float(ratio.max())]
    doc["points"] = int(valid.sum())
    return doc


def photometric_gauge(data: str, tmp: str) -> list:
    cam = parse_calib(os.path.join(data, "calib.txt"))
    photo_dir = os.path.join(tmp, "photo")
    os.makedirs(photo_dir)
    box, poses = gen.scene(), gen.trajectory(48)
    log_e, r2n = testing.exposure_walk(48), testing.photo_r2n()
    for k in range(48):
        img = testing.photo_distort(box.render(poses[k]).astype(np.float64), log_e[k], r2n)
        write_png(os.path.join(photo_dir, f"{k:06d}.png"), np.round(img).astype(np.uint8))
    reader = ImageReader(photo_dir, (640, 480))
    vo, _ = run_dataset.make_handler(cam, torch.device("cpu"), photo=True)
    vo.photo.solve_every = vo.photo.min_frames = 6
    problems = []
    solve = online_calib.solve_photometric

    def recording(*args, **kw):
        problems.append([a.numpy().copy() for a in args])
        return solve(*args, **kw)

    online_calib.solve_photometric = recording
    try:
        run_dataset.run_frames(vo, reader, 0, 48)
    finally:
        online_calib.solve_photometric = solve
    x = np.linspace(3 / 255, 252 / 255, 256)
    phi = np.stack([x ** k * (1 - x) for k in range(1, 5)], -1)
    out = []
    for inten, r2, valid in problems:
        def port(threads, perm=None):
            torch.set_num_threads(threads)
            cols = np.arange(inten.shape[1]) if perm is None else perm
            res = solve(*(torch.from_numpy(a[:, cols]) for a in (inten, r2, valid)))
            return {k: v.numpy().astype(np.float64) for k, v in res.items()}

        ref = port(1)
        others = {"port, 8 threads": port(8),
                  "port, points permuted": port(1, np.random.default_rng(0).permutation(
                      inten.shape[1])),
                  "jax": {k: np.asarray(v, np.float64) for k, v in jax_solve(
                      jnp.asarray(inten), jnp.asarray(r2), jnp.asarray(valid)).items()}}
        row = {"samples": list(inten.shape)}
        for name, o in others.items():
            alpha, mod_alpha = testing.exposure_gauge(o["log_e"], ref["log_e"])
            row[name] = dict(log_e=float(np.abs(o["log_e"] - ref["log_e"]).max()),
                             c=float(np.abs(o["c"] - ref["c"]).max()),
                             curve=float(np.abs(phi @ (o["c"] - ref["c"])).max()),
                             v=float(np.abs(o["v"] - ref["v"]).max()),
                             rms_after=abs(float(o["rms_after"] - ref["rms_after"])),
                             alpha_minus_1=alpha - 1.0, log_e_mod_alpha=mod_alpha)
        out.append(row)
    return out


def main() -> int:
    pin_float32_matmul()
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "box")
        gen.write_dataset(data, n=24)
        doc = {"ba_free_scale": ba_free_scale(data),
               "photometric_gauge": photometric_gauge(data, tmp)}
    print(json.dumps(doc, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

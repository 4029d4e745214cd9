"""Render the synthetic box sequence to disk in a dataset's layout.

Run from the repository root:

    python -m hso_tpu_torch.tools.make_synthetic_dataset out=<dir> [n=2200] [seed=3]

Writes ``<out>/images/%06d.png`` (8-bit grey, written by the port's own PNG
codec), ``<out>/times.txt`` (``<id> <stamp>`` lines, 30 frames/s),
``<out>/groundtruth.txt`` (TUM format, camera-to-world) and
``<out>/calib.txt`` (the 3-line pinhole calibration format), so
``python -m hso_tpu_torch.run_dataset`` runs it like a EuRoC folder and the
ATE tools can score it.  The trajectory, the scene (the textured box interior
with its stepped back wall, texture seed 3) and the file formats are those of
the JAX package's ``scripts/make_synthetic_dataset.py``; its 2,200 frames are
the boxseq-2200 sequence.
"""

from __future__ import annotations

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from hso_tpu_torch.cameras import PinholeCamera
from hso_tpu_torch.io.image_reader import write_png
from hso_tpu_torch.io.trajectory import rotation_to_quaternion
from hso_tpu_torch.math import se3np
from hso_tpu_torch.utils.synthetic import BoxScene

#: pinhole 640×480, the sequence's camera
W, H, FX, FY, CX, CY = 640, 480, 400.0, 400.0, 320.0, 240.0
FPS = 30.0


def trajectory(n: int) -> list:
    """Bounded loopy sweep inside the box: brisk enough for regular
    keyframes, periodic so the camera never leaves the scene."""
    poses = []
    for k in range(n):
        t = k / 18.0
        xi = np.r_[
            0.85 * np.sin(0.8 * t),
            0.14 * np.sin(0.5 * t),
            0.9 * np.sin(0.061 * t) + 0.12 * np.sin(0.35 * t),
            0.025 * np.sin(0.9 * t),
            -0.06 * np.sin(0.6 * t),
            0.02 * np.sin(0.4 * t),
        ]
        poses.append(se3np.exp(xi))
    return poses


def scene(seed: int = 3) -> BoxScene:
    cam = PinholeCamera(W, H, FX, FY, CX, CY)
    return BoxScene(cam, half_width=2.0, half_height=1.5, depth=4.5, seed=seed,
                    stepped_back=True)


def write_dataset(out: str, n: int = 2200, seed: int = 3, log=None) -> list:
    """Render ``n`` frames into ``out``; returns the ground-truth poses
    (world→camera).  Frames are rendered on a few threads, in chunks."""
    poses = trajectory(n)
    box = scene(seed)
    img_dir = os.path.join(out, "images")
    os.makedirs(img_dir, exist_ok=True)

    def render_and_write(k):
        write_png(os.path.join(img_dir, f"{k:06d}.png"), box.render(poses[k]).astype(np.uint8))

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        for lo in range(0, n, 200):
            list(pool.map(render_and_write, range(lo, min(n, lo + 200))))
            if log is not None:
                log(f"rendered {min(n, lo + 200)}/{n}")
    with open(os.path.join(out, "times.txt"), "w") as tf, \
            open(os.path.join(out, "groundtruth.txt"), "w") as gf:
        gf.write("# timestamp tx ty tz qx qy qz qw\n")
        for k, T in enumerate(poses):
            ts = k / FPS
            tf.write(f"{k:06d} {ts:.6f}\n")
            Twc = se3np.inv(T)
            t = se3np.translation(Twc)
            q = rotation_to_quaternion(se3np.rotation(Twc))
            gf.write(f"{ts:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                     f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")
    with open(os.path.join(out, "calib.txt"), "w") as cf:
        cf.write(f"Pinhole {FX} {FY} {CX} {CY} 0\n")
        cf.write(f"{W} {H}\n")
        cf.write("none\n")
    return poses


def main(argv=None) -> int:
    args = dict(a.split("=", 1) for a in (sys.argv[1:] if argv is None else argv) if "=" in a)
    out = args.get("out")
    if not out:
        print(__doc__)
        return 1
    n = int(args.get("n", 2200))
    write_dataset(out, n, int(args.get("seed", 3)),
                  log=lambda m: print(m, file=sys.stderr, flush=True))
    print(f"dataset written to {out} ({n} frames)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Drive the port's foundation through its public surface.

The port's counterpart of the JAX package's ``scripts/demo_foundation.py``:
on a synthetic textured 752×480 image, the frame pyramid on the device,
camera projection and back-projection through EuRoC's radial-tangential
model, an SE(3) walk round a circle, and whole-image undistortion on the
device, each printing what it observed:

    python -m hso_tpu_torch.tools.demo_foundation [cpu=1]

Runs on the GPU; ``cpu=1`` runs on the CPU, and without a GPU it exits 2
unless ``cpu=1`` is given.  All errors should be ≈ 1e-8 or below.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch
from scipy import ndimage

from hso_tpu_torch.cameras import PinholeCamera
from hso_tpu_torch.image.pyramid import build_frame_pyramids, remap_bilinear
from hso_tpu_torch.math import se3np
from hso_tpu_torch.tools.make_hard_artifact import device_of, hardware


def timed(fn, device):
    """(result, seconds) of ``fn()`` ended by a device synchronise."""
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def main(argv=None) -> int:
    args = dict(a.split("=", 1) for a in (sys.argv[1:] if argv is None else argv) if "=" in a)
    device = device_of(args, "demo_foundation")
    if device is None:
        return 2
    print("device:", hardware(device))

    # synthetic textured image: uniform noise blurred by a 7-tap Gaussian (σ 2)
    rng = np.random.default_rng(0)
    noise = rng.integers(0, 256, size=(480, 752)).astype(np.float32)
    img = np.round(ndimage.gaussian_filter(noise, 2.0, mode="mirror", truncate=1.5)).astype(
        np.uint8)

    out, t_first = timed(lambda: build_frame_pyramids(img, device=device), device)
    out, t_steady = timed(lambda: build_frame_pyramids(img, device=device), device)
    print(f"pyramid: first {t_first:.3f} s, steady-state {1e3 * t_steady:.2f} ms")
    print("  levels:", [tuple(p.shape) for p in out["pyr"]])
    print(f"  grad_mean={float(out['grad_mean']):.3f} "
          f"intensity_mean={float(out['intensity_mean']):.2f}")

    cam = PinholeCamera(752, 480, 458.654, 457.296, 367.215, 248.375,
                        -0.28340811, 0.07395907, 0.00019359, 1.76187114e-05)
    px = np.array([[100.0, 100.0], [376.0, 240.0], [700.0, 450.0]])
    f = cam.cam2world(px)
    print("camera roundtrip err (px):", np.abs(cam.world2cam(f * 2.5) - px).max())

    T = se3np.identity()
    for _ in range(8):
        T = se3np.mul(T, se3np.exp(np.r_[0.1, 0, 0, 0, 0, np.pi / 4]))
    print("8-step circular walk returns to identity, err:", np.abs(T - se3np.identity()).max())

    mx, my = cam.undistort_remap()
    img_d = torch.from_numpy(img).to(device)
    mx_d, my_d = torch.from_numpy(mx).to(device), torch.from_numpy(my).to(device)
    rect, t_rect = timed(lambda: remap_bilinear(img_d, mx_d, my_d), device)
    print(f"undistort remap on {device.type}: {t_rect:.3f} s, out shape {tuple(rect.shape)}, "
          f"mean {float(rect.mean()):.2f}")
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())

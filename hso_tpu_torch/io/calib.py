"""Camera calibration files, the 3-line format of the JAX package's
``hso_tpu/io/calib.py``:

    line 1: <Pinhole fx fy cx cy d0 d1 d2 d3> | <EQUI fx fy cx cy k0..k3>
            | <FOV fx fy cx cy omega>
    line 2: <width> <height>
    line 3: "true" | "false"   (whole-image undistortion)

Images larger than 848·800 px are resized (with intrinsics) to fit.
"""

from __future__ import annotations

import math

from hso_tpu_torch.cameras import EquidistantCamera, FOVCamera, PinholeCamera

MAX_RESOLUTION = 848 * 800


def parse_calib(path: str):
    """The camera a calibration file describes, rescaled to ``MAX_RESOLUTION``."""
    with open(path) as fh:
        lines = [ln.strip() for ln in fh.readlines() if ln.strip()]
    tok = lines[0].split()
    kind = tok[0][0].lower()
    vals = [float(t) for t in tok[1:]]
    w, h = (float(x) for x in lines[1].split()[:2])
    undistort = len(lines) > 2 and lines[2].lower().startswith("true")

    wi, hi = int(w), int(h)
    if w * h > MAX_RESOLUTION + 1e-8:
        rate = math.sqrt(w * h / MAX_RESOLUTION)
        wi, hi = int(w / rate), int(h / rate)
        rate = math.sqrt(w * h / (wi * hi))
        # normalised FOV intrinsics (< 1) scale with the image by themselves
        if kind != "f" or (vals[2] > 1 and vals[3] > 1):
            vals[0] /= rate
            vals[1] /= rate
            vals[2] /= rate
            vals[3] /= rate

    if kind == "p":
        d = vals[4:8] + [0.0]
        return PinholeCamera(wi, hi, *vals[:4], *d[:5], undistort_image=undistort)
    if kind == "e":
        return EquidistantCamera(wi, hi, *vals[:8])
    if kind == "f":
        return FOVCamera(wi, hi, *vals[:5], undistort_image=undistort)
    raise ValueError(f"unknown camera type in {path!r}: {tok[0]}")

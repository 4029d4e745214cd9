"""The photometric and structural corruption chain of the hard box sequence.

The port's counterpart of ``Torture`` in the JAX package's
``scripts/make_hard_artifact.py``, in numpy and scipy (the machine with the
card has no OpenCV).  It renders what auto-exposure footage does to a direct
method: a non-linear response (gamma), a strong radial vignette, an exposure
walk with step flicker, Gaussian read noise and Poisson-like shot noise,
motion blur along the image velocity on fast frames, and a textured
occluder orbiting the image centre.

It draws from its generator in the reference's order, so the same seed gives
the same exposures, the same occluder texture and the same noise.  OpenCV's
two filters are rebuilt to the reference's taps and borders:

  * ``GaussianBlur(t, (0, 0), 1.5)`` on float32 takes a kernel of
    ``round(2·4σ + 1) | 1`` = 13 taps with ``BORDER_REFLECT_101``:
    ``scipy.ndimage.gaussian_filter(σ=1.5, mode="mirror", truncate=4)``;
  * ``filter2D(img, -1, k)`` correlates with the anchor at the kernel's centre
    (``L // 2``) and ``BORDER_REFLECT_101``: ``scipy.ndimage.correlate(img, k,
    mode="mirror")``, whose centre is ``L // 2`` too.

scipy sums in float64 where OpenCV sums in float32, so a blurred frame agrees
to rounding, not to the bit (``tests/test_torch_validation_tools.py``).
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

from hso_tpu_torch.math import se3np

#: torture levels: gamma, vignette polynomial in r², exposure walk/step/clip
LEVELS = {
    "hard": dict(gamma=0.72, vig=(-0.42, -0.18), e_walk=0.05, e_step=0.18, e_clip=0.45),
    "extreme": dict(gamma=0.52, vig=(-0.95, -0.35), e_walk=0.08, e_step=0.30, e_clip=0.75),
}


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """OpenCV's ``GaussianBlur(img, (0, 0), sigma)`` of a float32 image."""
    return ndimage.gaussian_filter(img, sigma, mode="mirror", truncate=4.0).astype(np.float32)


def filter2d(img: np.ndarray, kern: np.ndarray) -> np.ndarray:
    """OpenCV's ``filter2D(img, -1, kern)`` of a float32 image (a correlation,
    anchor at the kernel's centre, reflect-101 borders)."""
    return ndimage.correlate(img, kern, mode="mirror").astype(np.float32)


def motion_kernel(px_vel) -> np.ndarray | None:
    """The directional blur kernel of an image velocity (px a frame), or None
    when the frame is slow (≤ 1.5 px)."""
    speed = float(np.hypot(*px_vel))
    if speed <= 1.5:
        return None
    L = int(np.clip(speed, 2, 7))
    kern = np.zeros((L, L), np.float32)
    c = (L - 1) / 2.0
    d = np.array(px_vel) / max(speed, 1e-6)
    for t in np.linspace(-c, c, 2 * L):
        x, y = int(round(c + t * d[0])), int(round(c + t * d[1]))
        kern[np.clip(y, 0, L - 1), np.clip(x, 0, L - 1)] += 1.0
    return kern / kern.sum()


class Torture:
    """Deterministic photometric and structural corruption of ``n`` frames of
    ``cam``'s size at one of :data:`LEVELS`."""

    def __init__(self, cam, n: int, level: str, seed: int = 11):
        self.p = LEVELS[level]
        rng = np.random.default_rng(seed)
        # auto-exposure: smooth walk plus step flicker every ~40 frames
        w, st_, cl = self.p["e_walk"], self.p["e_step"], self.p["e_clip"]
        log_e = np.cumsum(rng.uniform(-w, w, n))
        steps = np.zeros(n)
        for k in rng.integers(30, n - 1, max(2, n // 40)):
            steps[k:] += rng.uniform(-st_, st_)
        self.log_e = np.clip(log_e - log_e[0] + steps, -cl, cl)
        yy, xx = np.mgrid[0:cam.height, 0:cam.width]
        r2max = cam.cx ** 2 + cam.cy ** 2
        self.r2n = ((xx - cam.cx) ** 2 + (yy - cam.cy) ** 2) / r2max
        vig = self.p["vig"]
        self.vig = np.exp(vig[0] * self.r2n + vig[1] * self.r2n ** 2)
        self.rng = rng
        # occluder: textured patch orbiting the image centre
        self.occ_tex = gaussian_blur(rng.integers(10, 90, (90, 110)).astype(np.float32), 1.5)
        self.cam = cam

    def __call__(self, img_u8: np.ndarray, k: int, px_vel) -> np.ndarray:
        img = img_u8.astype(np.float32)
        kern = motion_kernel(px_vel)
        if kern is not None:
            img = filter2d(img, kern)
        h, w = img.shape
        ocy = int(h / 2 + 0.30 * h * np.sin(0.05 * k))
        ocx = int(w / 2 + 0.38 * w * np.cos(0.033 * k))
        oh, ow = self.occ_tex.shape
        y0, x0 = max(0, ocy - oh // 2), max(0, ocx - ow // 2)
        y1, x1 = min(h, y0 + oh), min(w, x0 + ow)
        img[y0:y1, x0:x1] = self.occ_tex[: y1 - y0, : x1 - x0]
        # radiometric chain: exposure, vignette, shot + read noise, response
        y = np.exp(self.log_e[k]) * self.vig * img
        y = y + self.rng.normal(0.0, 2.0, y.shape) \
            + self.rng.normal(0.0, 1.0, y.shape) * np.sqrt(np.maximum(y, 0) / 16.0)
        y = np.clip(y, 0.0, 255.0)
        out = 255.0 * (y / 255.0) ** self.p["gamma"]
        return np.clip(out, 0, 255).astype(np.uint8)


def image_velocities(cam, poses) -> list:
    """Image velocity of each frame (px a frame) from the camera centres, as
    the JAX package's script feeds the motion blur: the first frame's is 0."""
    cs = [se3np.translation(se3np.inv(T)) for T in poses]
    return [np.zeros(2)] + [cam.focal_mean * (cs[i] - cs[i - 1])[:2] / 2.0
                            for i in range(1, len(poses))]

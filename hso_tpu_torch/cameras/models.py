"""Concrete camera models: pinhole with radial-tangential distortion, FOV
(ATAN) and equidistant fisheye.  The radial-tangential distortion is inverted
by a fixed-point iteration with a fixed trip count.  :func:`projection_model`
says how a camera's ``world2cam`` projects, for the kernels that project
without the camera object (K3).
"""

from __future__ import annotations

import math

import numpy as np

from hso_tpu_torch.cameras.base import AbstractCamera, _xp


class PinholeCamera(AbstractCamera):
    """Pinhole with radial-tangential distortion d = [k1 k2 p1 p2 k3]."""

    def __init__(self, width, height, fx, fy, cx, cy,
                 d0=0.0, d1=0.0, d2=0.0, d3=0.0, d4=0.0, undistort_image=False):
        super().__init__(width, height, fx, fy, cx, cy)
        self.d = (float(d0), float(d1), float(d2), float(d3), float(d4))
        self.has_distortion = abs(d0) > 1e-7
        self.undistort_image = bool(undistort_image)

    def distort(self, x, y):
        if not self.has_distortion:
            return x, y
        k1, k2, p1, p2, k3 = self.d
        r2 = x * x + y * y
        r4 = r2 * r2
        r6 = r4 * r2
        a1 = 2.0 * x * y
        a2 = r2 + 2.0 * x * x
        a3 = r2 + 2.0 * y * y
        cdist = 1.0 + k1 * r2 + k2 * r4 + k3 * r6
        xd = x * cdist + p1 * a1 + p2 * a2
        yd = y * cdist + p1 * a3 + p2 * a1
        return xd, yd

    def undistort(self, xd, yd, n_iter: int = 20):
        if not self.has_distortion:
            return xd, yd
        k1, k2, p1, p2, k3 = self.d
        x, y = xd, yd
        for _ in range(n_iter):  # fixed-point iteration, fixed trip count
            r2 = x * x + y * y
            icdist = 1.0 / (1.0 + ((k3 * r2 + k2) * r2 + k1) * r2)
            dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
            dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
            x = (xd - dx) * icdist
            y = (yd - dy) * icdist
        return x, y


class FOVCamera(AbstractCamera):
    """FOV / ATAN model (Devernay-Faugeras), used by TUM MonoVO.

    Normalised intrinsics (< 1.0) are scaled by the image size.  With
    ``undistort_image=True`` the model acts as an ideal pinhole over
    pre-rectified images; otherwise the per-point ATAN warp is live."""

    def __init__(self, width, height, fx, fy, cx, cy, omega, undistort_image=False):
        if cx < 1.0 and cy < 1.0:
            fx, fy, cx, cy = fx * width, fy * height, cx * width, cy * height
        super().__init__(width, height, fx, fy, cx, cy)
        self.omega = float(omega)
        self.undistort_image = bool(undistort_image)
        self.has_distortion = (not undistort_image) and abs(self.omega) > 1e-9

    def distort(self, x, y):
        if not self.has_distortion:
            return x, y
        xp = _xp(x)
        r = xp.sqrt(x * x + y * y)
        rsafe = xp.clamp_min(r, 1e-12)
        fac = xp.arctan(2.0 * rsafe * math.tan(self.omega / 2.0)) / (rsafe * self.omega)
        fac = xp.where(r < 1e-12, xp.ones_like(fac), fac)
        return fac * x, fac * y

    def undistort(self, xd, yd):
        if not self.has_distortion:
            return xd, yd
        xp = _xp(xd)
        rd = xp.sqrt(xd * xd + yd * yd)
        rdsafe = xp.clamp_min(rd, 1e-12)
        fac = xp.tan(rdsafe * self.omega) / (2.0 * rdsafe * math.tan(self.omega / 2.0))
        fac = xp.where(rd < 1e-12, xp.ones_like(fac), fac)
        return fac * xd, fac * yd


class EquidistantCamera(AbstractCamera):
    """Equidistant (Kannala-Brandt) fisheye, k = [k0..k3].

    Whole images are always pre-rectified for this model and points then
    treated as ideal pinhole; the distortion is only used to build the remap."""

    def __init__(self, width, height, fx, fy, cx, cy, k0, k1, k2, k3):
        super().__init__(width, height, fx, fy, cx, cy)
        self.k = (float(k0), float(k1), float(k2), float(k3))
        self.undistort_image = True
        self.has_distortion = False  # per-point path is ideal after remap

    def _equi_distort(self, x, y):
        xp = _xp(x)
        k0, k1, k2, k3 = self.k
        r = xp.sqrt(x * x + y * y)
        theta = xp.arctan(r)
        t2 = theta * theta
        t4 = t2 * t2
        t6 = t4 * t2
        t8 = t4 * t4
        thetad = theta * (1.0 + k0 * t2 + k1 * t4 + k2 * t6 + k3 * t8)
        scaling = xp.where(r > 1e-8, thetad / xp.clamp_min(r, 1e-12), xp.ones_like(r))
        return x * scaling, y * scaling

    def undistort_remap(self):
        v, u = np.mgrid[0: self.height, 0: self.width].astype(np.float64)
        x = (u - self.cx) / self.fx
        y = (v - self.cy) / self.fy
        xd, yd = self._equi_distort(x, y)
        return ((xd * self.fx + self.cx).astype(np.float32),
                (yd * self.fy + self.cy).astype(np.float32))


#: the projection models a kernel takes, by their number in ``csrc/coarse.cu``
PROJECTIONS = {"ideal": 0, "radtan": 1, "fov": 2}


def projection_model(cam):
    """How ``cam.world2cam`` projects a camera-frame point, as
    ``(model, coefficients)``: ``("ideal", ())``, ``("radtan", (k1, k2, p1, p2,
    k3))`` or ``("fov", (omega, 2·tan(omega/2)))``; ``None`` for a camera whose
    projection is none of these (a subclass with its own ``distort`` or
    ``world2cam``).  Decided by the camera's own ``has_distortion``, the flag
    its ``distort`` reads, not by its class: the ideal pinhole of ``ideal()``,
    a rectified FOV camera, an equidistant camera (its images are always
    rectified) and a pinhole without distortion all project ``ideal``."""
    kind = type(cam)
    if (kind.world2cam is not AbstractCamera.world2cam
            or kind.world2cam_uv is not AbstractCamera.world2cam_uv):
        return None
    if kind.distort is AbstractCamera.distort:
        return "ideal", ()
    if kind.distort is PinholeCamera.distort:
        return ("radtan", cam.d) if cam.has_distortion else ("ideal", ())
    if kind.distort is FOVCamera.distort:
        if not cam.has_distortion:
            return "ideal", ()
        return "fov", (cam.omega, 2.0 * math.tan(cam.omega / 2.0))
    return None

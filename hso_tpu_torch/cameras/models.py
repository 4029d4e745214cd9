"""Concrete camera models.  Ported so far: pinhole with radial-tangential
distortion.  The FOV (ATAN) and equidistant fisheye models of the JAX
package are not ported yet.
"""

from __future__ import annotations

from hso_tpu_torch.cameras.base import AbstractCamera


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

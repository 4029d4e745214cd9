"""Camera interface.

Every method is batched over arbitrary leading dimensions and polymorphic
over the array type: numpy in ⇒ numpy out (host bookkeeping, scene
rendering), torch in ⇒ torch out on the input's device.  Intrinsics are
Python floats.
"""

from __future__ import annotations

import numpy as np
import torch


class _NumpyOps:
    stack = staticmethod(lambda xs: np.stack(xs, axis=-1))
    where = staticmethod(np.where)
    abs = staticmethod(np.abs)
    floor = staticmethod(np.floor)
    full_like = staticmethod(np.full_like)
    ones_like = staticmethod(np.ones_like)
    norm = staticmethod(lambda f: np.linalg.norm(f, axis=-1, keepdims=True))
    sqrt = staticmethod(np.sqrt)
    arctan = staticmethod(np.arctan)
    tan = staticmethod(np.tan)
    clamp_min = staticmethod(np.maximum)


class _TorchOps:
    stack = staticmethod(lambda xs: torch.stack(xs, dim=-1))
    where = staticmethod(torch.where)
    abs = staticmethod(torch.abs)
    floor = staticmethod(torch.floor)
    full_like = staticmethod(torch.full_like)
    ones_like = staticmethod(torch.ones_like)
    norm = staticmethod(lambda f: torch.linalg.norm(f, dim=-1, keepdim=True))
    sqrt = staticmethod(torch.sqrt)
    arctan = staticmethod(torch.atan)
    tan = staticmethod(torch.tan)
    clamp_min = staticmethod(torch.clamp_min)


def _xp(a):
    """Pick the op set from the argument's array type."""
    return _TorchOps if isinstance(a, torch.Tensor) else _NumpyOps


class AbstractCamera:
    """Pinhole-core camera; subclasses add distortion in unit-plane space."""

    def __init__(self, width: int, height: int, fx: float, fy: float, cx: float, cy: float):
        self.width = int(width)
        self.height = int(height)
        self.fx, self.fy, self.cx, self.cy = float(fx), float(fy), float(cx), float(cy)
        # mean focal length, converts unit-plane errors to pixels
        self.focal_mean = abs(fx) if fx * fy < 0 else abs((fx + fy) * 0.5)

    # -- distortion hooks (identity by default) ------------------------------
    def distort(self, x, y):
        """unit-plane (x, y) -> distorted unit-plane coordinates."""
        return x, y

    def undistort(self, xd, yd):
        """distorted unit-plane -> ideal unit-plane coordinates."""
        return xd, yd

    # -- core API ------------------------------------------------------------
    def world2cam_uv(self, uv):
        """unit-plane coords (..., 2) -> pixel coords (..., 2)."""
        xd, yd = self.distort(uv[..., 0], uv[..., 1])
        return _xp(uv).stack([xd * self.fx + self.cx, yd * self.fy + self.cy])

    def world2cam(self, xyz):
        """camera-frame points (..., 3) -> pixel coords (..., 2).

        No chirality check here; callers mask on z > 0 themselves.
        """
        xp = _xp(xyz)
        z = xyz[..., 2]
        zsafe = xp.where(xp.abs(z) < 1e-12, xp.full_like(z, 1e-12), z)
        uv = xp.stack([xyz[..., 0] / zsafe, xyz[..., 1] / zsafe])
        return self.world2cam_uv(uv)

    def cam2world(self, px):
        """pixel coords (..., 2) -> unit bearing vectors (..., 3)."""
        xp = _xp(px)
        xd = (px[..., 0] - self.cx) / self.fx
        yd = (px[..., 1] - self.cy) / self.fy
        x, y = self.undistort(xd, yd)
        f = xp.stack([x, y, xp.ones_like(x)])
        return f / xp.norm(f)

    def is_in_frame(self, px, border: float = 0.0, level: int = 0):
        """True where the integer pixel fits inside the level-``level`` image
        with ``border`` margin."""
        xp = _xp(px)
        w = self.width >> level
        h = self.height >> level
        u = xp.floor(px[..., 0])
        v = xp.floor(px[..., 1])
        return (u >= border) & (u < w - border) & (v >= border) & (v < h - border)

    # -- whole-image undistortion -------------------------------------------
    def undistort_remap(self):
        """Build (map_x, map_y) float32 numpy arrays of shape (H, W): for each
        rectified pixel, the source pixel in the raw (distorted) image.
        Rectified images use the same K."""
        v, u = np.mgrid[0: self.height, 0: self.width].astype(np.float64)
        x = (u - self.cx) / self.fx
        y = (v - self.cy) / self.fy
        xd, yd = self.distort(x, y)
        map_x = (xd * self.fx + self.cx).astype(np.float32)
        map_y = (yd * self.fy + self.cy).astype(np.float32)
        return map_x, map_y

    def ideal(self) -> "AbstractCamera":
        """The distortion-free pinhole with the same K (what the pipeline uses
        after whole-image undistortion)."""
        return AbstractCamera(self.width, self.height, self.fx, self.fy, self.cx, self.cy)

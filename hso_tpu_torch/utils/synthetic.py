"""Synthetic scene renderers: ground-truth data for tests and smoke runs.

``PlaneScene`` renders views of a textured plane (world z = z0) and
``BoxScene`` a textured box interior, for any camera pose with known
per-pixel depth.  Pure host-side numpy/scipy; not part of the measured
compute path.  The textures are blurred with
``scipy.ndimage.gaussian_filter(σ=2, mode="mirror", truncate=4)``: a
17-tap kernel with reflect-101 borders, the filter OpenCV's
``GaussianBlur(t, (0, 0), 2.0)`` applies to a float32 image, so frames
agree with the JAX package's renderer to a grey level.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

from hso_tpu_torch.math import se3np


def _texture(rng, tex_size: int, blur: float) -> np.ndarray:
    t = rng.integers(0, 256, size=(tex_size, tex_size)).astype(np.float32)
    t = ndimage.gaussian_filter(t, blur, mode="mirror", truncate=4.0)
    # renormalize to a healthy contrast range
    return (t - t.min()) / (t.max() - t.min()) * 220.0 + 15.0


def _bilinear_zero_border(tex: np.ndarray, tx: np.ndarray, ty: np.ndarray) -> np.ndarray:
    """Bilinear texture read with a constant-0 border (texels outside read 0)."""
    n = tex.shape[0]
    x0 = np.floor(tx).astype(np.int64)
    y0 = np.floor(ty).astype(np.int64)
    fx = (tx - x0).astype(np.float32)
    fy = (ty - y0).astype(np.float32)

    def tap(xi, yi):
        inside = (xi >= 0) & (xi < n) & (yi >= 0) & (yi < n)
        return np.where(inside, tex[np.clip(yi, 0, n - 1), np.clip(xi, 0, n - 1)], 0.0)

    return (tap(x0, y0) * (1 - fx) * (1 - fy) + tap(x0 + 1, y0) * fx * (1 - fy)
            + tap(x0, y0 + 1) * (1 - fx) * fy + tap(x0 + 1, y0 + 1) * fx * fy)


class PlaneScene:
    def __init__(self, cam, z0: float = 2.0, extent: float = 2.0, tex_size: int = 2048,
                 seed: int = 0, blur: float = 2.0, tex=None):
        self.cam = cam
        self.z0 = float(z0)
        self.extent = float(extent)  # plane spans [-extent, extent] in x and y
        if tex is None:
            tex = _texture(np.random.default_rng(seed), tex_size, blur)
        else:
            tex = np.asarray(tex, np.float32)
            tex_size = tex.shape[0]
        self.tex = tex
        self.tex_size = tex_size

    def _rays(self, px, T_c_w):
        if T_c_w is None:
            T_c_w = se3np.identity()
        T_w_c = se3np.inv(T_c_w)
        f_w = se3np.rotate(T_w_c, self.cam.cam2world(px))
        return f_w, se3np.translation(T_w_c)

    def render(self, T_c_w=None, exposure: float = 1.0) -> np.ndarray:
        """Render the uint8 view from camera pose ``T_c_w`` (world→camera)."""
        h, w = self.cam.height, self.cam.width
        v, u = np.mgrid[0:h, 0:w].astype(np.float64)
        f_w, t_w = self._rays(np.stack([u.reshape(-1), v.reshape(-1)], axis=-1), T_c_w)
        lam = (self.z0 - t_w[2]) / f_w[:, 2]
        p_w = t_w[None, :] + lam[:, None] * f_w
        s = self.tex_size / (2.0 * self.extent)
        tx = ((p_w[:, 0] + self.extent) * s).astype(np.float32)
        ty = ((p_w[:, 1] + self.extent) * s).astype(np.float32)
        img = _bilinear_zero_border(self.tex, tx, ty)
        img = np.where(lam <= 0, 0.0, img).reshape(h, w) * exposure
        return np.clip(img, 0, 255).astype(np.uint8)

    def depth_along_ray(self, px: np.ndarray, T_c_w=None) -> np.ndarray:
        """Ground-truth distance along the bearing for pixels (N, 2)."""
        f_w, t_w = self._rays(px, T_c_w)
        return (self.z0 - t_w[2]) / f_w[:, 2]

    def grid_features(self, step: int = 24, border: int = 24, T_c_w=None):
        """Regular grid of features: (px (N,2), f (N,3), dist (N,))."""
        h, w = self.cam.height, self.cam.width
        us = np.arange(border, w - border, step, dtype=np.float64)
        vs = np.arange(border, h - border, step, dtype=np.float64)
        uu, vv = np.meshgrid(us, vs)
        px = np.stack([uu.reshape(-1), vv.reshape(-1)], axis=-1)
        return px, self.cam.cam2world(px), self.depth_along_ray(px, T_c_w)


class BoxScene:
    """Textured box interior (corridor): two side walls, floor, ceiling, and
    a back wall — multi-depth structure with discontinuities.  Camera at the
    origin looks down +z; the box spans x ∈ [-hw, hw], y ∈ [-hh, hh],
    z ∈ (-∞, depth]."""

    def __init__(self, cam, half_width: float = 2.0, half_height: float = 1.5,
                 depth: float = 6.0, tex_size: int = 2048, seed: int = 0,
                 blur: float = 2.0, stepped_back: bool = False):
        self.cam = cam
        rng = np.random.default_rng(seed)

        def tex():
            return _texture(rng, tex_size, blur)

        self.tex_size = tex_size
        hw, hh, d = float(half_width), float(half_height), float(depth)
        self.extent = max(hw, hh, d)
        m = 4.0  # texture margin beyond the nominal box, for camera excursions
        # entries: (p0, inward normal, u axis, v axis, (u_lo, u_hi) texture
        # range, (v_lo, v_hi), texture, hit_xlim); hit_xlim optionally bounds
        # accepted intersections in world x (for the stepped back wall)
        self.planes = [
            (np.r_[hw, 0, 0], np.r_[-1.0, 0, 0], np.r_[0, 0, 1.0], np.r_[0, 1.0, 0],
             (-m, d + m), (-hh - m, hh + m), tex(), None),
            (np.r_[-hw, 0, 0], np.r_[1.0, 0, 0], np.r_[0, 0, 1.0], np.r_[0, 1.0, 0],
             (-m, d + m), (-hh - m, hh + m), tex(), None),
            (np.r_[0, hh, 0], np.r_[0, -1.0, 0], np.r_[1.0, 0, 0], np.r_[0, 0, 1.0],
             (-hw - m, hw + m), (-m, d + m), tex(), None),
            (np.r_[0, -hh, 0], np.r_[0, 1.0, 0], np.r_[1.0, 0, 0], np.r_[0, 0, 1.0],
             (-hw - m, hw + m), (-m, d + m), tex(), None),
        ]
        back = (np.r_[0, 0, -1.0], np.r_[1.0, 0, 0], np.r_[0, 1.0, 0],
                (-hw - m, hw + m), (-hh - m, hh + m))
        if stepped_back:
            # near slab on the left half, far wall behind it: frontal
            # structure at two depths with an occlusion edge down the middle
            self.planes.append((np.r_[0, 0, 0.55 * d], *back, tex(), (-np.inf, 0.0)))
        self.planes.append((np.r_[0, 0, d], *back, tex(), None))

    def _raycast(self, f_w: np.ndarray, t_w: np.ndarray):
        """Nearest positive plane hit per ray → (lam (N,), plane index)."""
        n = f_w.shape[0]
        lam_best = np.full(n, np.inf)
        idx_best = np.full(n, -1, np.int64)
        for i, plane in enumerate(self.planes):
            p0, nrm, xlim = plane[0], plane[1], plane[7]
            denom = f_w @ nrm
            with np.errstate(divide="ignore", invalid="ignore"):
                lam = ((p0 - t_w) @ nrm) / denom
            ok = (denom < -1e-9) & (lam > 1e-6) & (lam < lam_best)
            if xlim is not None:
                hit_x = t_w[0] + lam * f_w[:, 0]
                ok &= (hit_x >= xlim[0]) & (hit_x <= xlim[1])
            lam_best = np.where(ok, lam, lam_best)
            idx_best = np.where(ok, i, idx_best)
        return lam_best, idx_best

    def _rays(self, px, T_c_w):
        if T_c_w is None:
            T_c_w = se3np.identity()
        T_w_c = se3np.inv(T_c_w)
        f_w = se3np.rotate(T_w_c, self.cam.cam2world(px))
        return f_w, se3np.translation(T_w_c)

    def render(self, T_c_w=None, exposure: float = 1.0) -> np.ndarray:
        h, w = self.cam.height, self.cam.width
        v, u = np.mgrid[0:h, 0:w].astype(np.float64)
        f_w, t_w = self._rays(np.stack([u.reshape(-1), v.reshape(-1)], axis=-1), T_c_w)
        lam, pidx = self._raycast(f_w, t_w)
        out = np.zeros(h * w, np.float32)
        for i, (p0, _nrm, axu, axv, ur, vr, tex, _xlim) in enumerate(self.planes):
            m = pidx == i
            if not m.any():
                continue
            hit = t_w[None, :] + lam[m, None] * f_w[m]
            tu = ((hit - p0) @ axu - ur[0]) / (ur[1] - ur[0]) * self.tex_size
            tv = ((hit - p0) @ axv - vr[0]) / (vr[1] - vr[0]) * self.tex_size
            tu = np.clip(tu, 0, self.tex_size - 1.001)
            tv = np.clip(tv, 0, self.tex_size - 1.001)
            u0 = tu.astype(np.int64)
            v0 = tv.astype(np.int64)
            fu = (tu - u0).astype(np.float32)
            fv = (tv - v0).astype(np.float32)
            out[m] = (tex[v0, u0] * (1 - fu) * (1 - fv) + tex[v0, u0 + 1] * fu * (1 - fv)
                      + tex[v0 + 1, u0] * (1 - fu) * fv + tex[v0 + 1, u0 + 1] * fu * fv)
        img = out.reshape(h, w) * exposure
        return np.clip(img, 0, 255).astype(np.uint8)

    def depth_along_ray(self, px: np.ndarray, T_c_w=None) -> np.ndarray:
        f_w, t_w = self._rays(px, T_c_w)
        return self._raycast(f_w, t_w)[0]

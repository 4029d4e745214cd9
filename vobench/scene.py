"""The benchmark's imagery: a textured box interior seen through a camera
model, rendered with PyTorch on the device.

Frozen from ``hso_tpu_torch/utils/synthetic.py`` (``_texture``,
``BoxScene``: planes, ray cast, bilinear texture read),
``hso_tpu_torch/cameras/models.py`` (``PinholeCamera.undistort``, the
radial-tangential model inverted by 20 fixed-point steps; ``FOVCamera``, the
ATAN model and its normalised intrinsics) and ``hso_tpu_torch/io/calib.py``
(the rescale of a calibration to ``MAX_RESOLUTION``), so that a change to the
program cannot move the frames the benchmark feeds it.  The textures are drawn
on the host (numpy and scipy, once a run); the rays, the ray cast and the
texture reads run in float64/float32 on whatever device the tensors live on.

A configuration may add the camera's photometric chain (:class:`Photometry`):
each frame's exposure, the lens's vignette and the sensor's response between
the texture's radiance and the stored grey value.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy import ndimage

MAX_RESOLUTION = 848 * 800   #: pixels above which a calibration is rescaled, as the program does


def texture(rng, tex_size: int, blur: float) -> np.ndarray:
    t = rng.integers(0, 256, size=(tex_size, tex_size)).astype(np.float32)
    t = ndimage.gaussian_filter(t, blur, mode="mirror", truncate=4.0)
    return (t - t.min()) / (t.max() - t.min()) * 220.0 + 15.0


class Camera:
    """Pinhole with radial-tangential distortion ``d = (k1, k2, p1, p2, k3)``,
    as a calibration line of the dataset states it."""

    def __init__(self, width, height, fx, fy, cx, cy, d=(0.0, 0.0, 0.0, 0.0, 0.0)):
        self.width, self.height = int(width), int(height)
        self.fx, self.fy, self.cx, self.cy = float(fx), float(fy), float(cx), float(cy)
        self.d = tuple(float(x) for x in (tuple(d) + (0.0,) * 5)[:5])
        self.has_distortion = abs(self.d[0]) > 1e-7

    def undistort(self, xd, yd, n_iter: int = 20):
        if not self.has_distortion:
            return xd, yd
        k1, k2, p1, p2, k3 = self.d
        x, y = xd, yd
        for _ in range(n_iter):
            r2 = x * x + y * y
            icdist = 1.0 / (1.0 + ((k3 * r2 + k2) * r2 + k1) * r2)
            dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
            dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
            x = (xd - dx) * icdist
            y = (yd - dy) * icdist
        return x, y

    def bearings(self, px: torch.Tensor) -> torch.Tensor:
        """Unit bearings (N, 3) float64 of pixels (N, 2)."""
        px = px.to(torch.float64)
        x, y = self.undistort((px[:, 0] - self.cx) / self.fx, (px[:, 1] - self.cy) / self.fy)
        f = torch.stack([x, y, torch.ones_like(x)], dim=-1)
        return f / f.norm(dim=-1, keepdim=True)

    def pixel_bearings(self, device) -> torch.Tensor:
        """Bearings of every pixel centre, (H·W, 3) row-major."""
        v, u = torch.meshgrid(torch.arange(self.height, dtype=torch.float64, device=device),
                              torch.arange(self.width, dtype=torch.float64, device=device),
                              indexing="ij")
        return self.bearings(torch.stack([u.reshape(-1), v.reshape(-1)], dim=-1))


class FOVCamera(Camera):
    """FOV (ATAN) model of Devernay and Faugeras with distortion ``omega``, as
    TUM MonoVO publishes it; intrinsics below 1 are shares of the image size."""

    def __init__(self, width, height, fx, fy, cx, cy, omega):
        if cx < 1.0 and cy < 1.0:
            fx, fy, cx, cy = fx * width, fy * height, cx * width, cy * height
        super().__init__(width, height, fx, fy, cx, cy)
        self.omega = float(omega)
        self.has_distortion = abs(self.omega) > 1e-9

    def undistort(self, xd, yd):
        if not self.has_distortion:
            return xd, yd
        rd = torch.sqrt(xd * xd + yd * yd)
        rdsafe = torch.clamp_min(rd, 1e-12)
        fac = torch.tan(rdsafe * self.omega) / (2.0 * rdsafe * math.tan(self.omega / 2.0))
        fac = torch.where(rd < 1e-12, torch.ones_like(fac), fac)
        return fac * xd, fac * yd


def rescaled(model: str, width: float, height: float, vals: list) -> tuple[int, int, list]:
    """A calibration's size and parameters after the program's rescale of an
    image larger than ``MAX_RESOLUTION`` (normalised FOV intrinsics, below 1,
    scale with the image by themselves)."""
    vals = [float(v) for v in vals]
    wi, hi = int(width), int(height)
    if width * height > MAX_RESOLUTION + 1e-8:
        rate = math.sqrt(width * height / MAX_RESOLUTION)
        wi, hi = int(width / rate), int(height / rate)
        rate = math.sqrt(width * height / (wi * hi))
        if model[0].lower() != "f" or (vals[2] > 1 and vals[3] > 1):
            vals[:4] = [v / rate for v in vals[:4]]
    return wi, hi, vals


def camera(cal: dict) -> Camera:
    """The camera that takes the frames, from a configuration's calibration as
    the dataset publishes it: ``Pinhole`` (``fx``, ``fy``, ``cx``, ``cy``,
    ``distortion``) or ``FOV`` (``params``: fx, fy, cx, cy, omega), each at
    the size the program rescales it to."""
    if cal["model"] == "Pinhole":
        vals = [cal["fx"], cal["fy"], cal["cx"], cal["cy"], *cal["distortion"]]
        w, h, vals = rescaled("Pinhole", cal["width"], cal["height"], vals)
        return Camera(w, h, *vals[:4], vals[4:])
    if cal["model"] == "FOV":
        w, h, vals = rescaled("FOV", cal["width"], cal["height"], cal["params"])
        return FOVCamera(w, h, *vals[:5])
    raise ValueError(f"no camera model {cal['model']!r}: Pinhole or FOV")


class Photometry:
    """The camera's photometric chain from the texture's radiance ``L`` to the
    grey value ``O = U⁻¹(e_j · V(r) · L)`` of frame ``j``, as the online
    calibration models it (Bergmann, Wang and Cremers, RA-L 2018):

    * ``vignette``: ``V = 1 + Σ_k a_k R^k`` over ``R = r² / r²_max``, the
      squared distance from the principal point over the farthest corner's;
    * ``inverse_response``: ``U`` as 256 strictly increasing values, the
      irradiance of each grey value (the format of TUM MonoVO's
      ``pcalib.txt``); ``U⁻¹`` interpolates it linearly;
    * ``exposure``: ``e_j``, a walk of ``log e`` from 0 that takes a step
      drawn uniformly from ``[-log_step, log_step]`` every ``step_seconds``,
      clipped to ``log_range``; ``rng`` draws it.

    The truth stays here for the checks: ``exposure`` (one a frame),
    ``inverse_response``, ``vignette`` (the coefficients) and
    :meth:`vignette_at`."""

    def __init__(self, block: dict, cam: Camera, n_frames: int, rate_hz: float, rng,
                 device="cpu"):
        self.vignette = [float(a) for a in block["vignette"]]
        u = np.asarray(block["inverse_response"], np.float64)
        if u.shape != (256,) or not np.all(np.diff(u) > 0):
            raise ValueError("inverse_response: 256 strictly increasing values")
        self.inverse_response = u
        ex = block["exposure"]
        lo, hi = (float(x) for x in ex["log_range"])
        n_steps = int(math.ceil(n_frames / rate_hz / float(ex["step_seconds"]))) + 1
        steps = rng.uniform(-float(ex["log_step"]), float(ex["log_step"]), n_steps)
        walk = np.empty(n_steps)
        x = 0.0
        for i, d in enumerate(steps):
            walk[i] = x
            x = min(max(x + d, lo), hi)
        step_of = (np.arange(n_frames) / rate_hz / float(ex["step_seconds"])).astype(np.int64)
        self.exposure = np.exp(walk[step_of])
        self.cx, self.cy = cam.cx, cam.cy
        self.r2_max = max((x0 - cam.cx) ** 2 + (y0 - cam.cy) ** 2
                          for x0 in (0, cam.width - 1) for y0 in (0, cam.height - 1))
        v, uu = np.mgrid[0:cam.height, 0:cam.width]
        vmap = self.vignette_at((uu - cam.cx) ** 2 + (v - cam.cy) ** 2).reshape(-1)
        if not np.all(vmap > 0):
            raise ValueError("vignette: V(r) is not positive over the image")
        dev = torch.device(device)
        self._v = torch.from_numpy(vmap.astype(np.float32)).to(dev)
        self._u = torch.from_numpy(u.astype(np.float32)).to(dev)
        self._e = torch.from_numpy(self.exposure.astype(np.float32)).to(dev)

    def vignette_at(self, r2) -> np.ndarray:
        """``V`` at squared pixel distances ``r2`` from the principal point."""
        big_r = np.asarray(r2, np.float64) / self.r2_max
        return 1.0 + sum(a * big_r ** (k + 1) for k, a in enumerate(self.vignette))

    def observe(self, radiance: torch.Tensor, first: int) -> torch.Tensor:
        """Grey values (B, N) float32, before the clip and the cast, of the
        radiance (B, N) of frames ``first..first+B-1``."""
        e = self._e[first:first + radiance.shape[0]]
        irr = e[:, None] * (self._v[None, :] * radiance)
        k = (torch.searchsorted(self._u, irr.contiguous(), right=True) - 1).clamp(0, 254)
        lo, hi = self._u[k], self._u[k + 1]
        return k.to(torch.float32) + (irr - lo) / (hi - lo)


class BoxScene:
    """Textured box interior: two side walls, floor, ceiling and a back wall
    (with ``stepped_back`` a near slab on the left half in front of it).  The
    camera at the origin looks down +z; the box spans x in [-hw, hw], y in
    [-hh, hh], z up to ``depth``.  ``seed`` draws the textures."""

    def __init__(self, half_width: float, half_height: float, depth: float, seed: int,
                 tex_size: int = 2048, blur: float = 2.0, stepped_back: bool = True,
                 device="cpu"):
        rng = np.random.default_rng(seed)
        self.tex_size = tex_size
        self.device = torch.device(device)
        hw, hh, d = float(half_width), float(half_height), float(depth)
        m = 4.0   # texture margin beyond the nominal box
        # (p0, inward normal, u axis, v axis, u range, v range, hit x limit)
        geo = [
            ((hw, 0, 0), (-1.0, 0, 0), (0, 0, 1.0), (0, 1.0, 0), (-m, d + m), (-hh - m, hh + m),
             None),
            ((-hw, 0, 0), (1.0, 0, 0), (0, 0, 1.0), (0, 1.0, 0), (-m, d + m), (-hh - m, hh + m),
             None),
            ((0, hh, 0), (0, -1.0, 0), (1.0, 0, 0), (0, 0, 1.0), (-hw - m, hw + m), (-m, d + m),
             None),
            ((0, -hh, 0), (0, 1.0, 0), (1.0, 0, 0), (0, 0, 1.0), (-hw - m, hw + m), (-m, d + m),
             None),
        ]
        back = ((0, 0, -1.0), (1.0, 0, 0), (0, 1.0, 0), (-hw - m, hw + m), (-hh - m, hh + m))
        if stepped_back:
            geo.append(((0, 0, 0.55 * d),) + back + ((-math.inf, 0.0),))
        geo.append(((0, 0, d),) + back + (None,))
        self.textures = [texture(rng, tex_size, blur) for _ in geo]
        self.planes = []
        for (p0, nrm, axu, axv, ur, vr, xlim), tex in zip(geo, self.textures):
            t64 = lambda v: torch.tensor(v, dtype=torch.float64, device=self.device)  # noqa: E731
            self.planes.append(dict(p0=t64(p0), n=t64(nrm), u=t64(axu), v=t64(axv), ur=ur,
                                    vr=vr, xlim=xlim,
                                    tex=torch.from_numpy(tex).to(self.device).reshape(-1)))

    def raycast(self, f_w: torch.Tensor, t_w: torch.Tensor):
        """Nearest positive plane hit per ray: (distance (..., ), plane index).
        ``f_w`` (..., 3) unit rays in the world, ``t_w`` (..., 3) their origins."""
        lam_best = torch.full(f_w.shape[:-1], math.inf, dtype=torch.float64, device=f_w.device)
        idx_best = torch.full(f_w.shape[:-1], -1, dtype=torch.int64, device=f_w.device)
        for i, pl in enumerate(self.planes):
            denom = f_w @ pl["n"]
            lam = ((pl["p0"] - t_w) @ pl["n"]) / denom
            ok = (denom < -1e-9) & (lam > 1e-6) & (lam < lam_best)
            if pl["xlim"] is not None:
                hit_x = t_w[..., 0] + lam * f_w[..., 0]
                ok &= (hit_x >= pl["xlim"][0]) & (hit_x <= pl["xlim"][1])
            lam_best = torch.where(ok, lam, lam_best)
            idx_best = torch.where(ok, torch.full_like(idx_best, i), idx_best)
        return lam_best, idx_best

    def render(self, f_c: torch.Tensor, T_c_w: torch.Tensor) -> torch.Tensor:
        """uint8 views (B, N) for camera poses ``T_c_w`` (B, 3, 4) world→camera,
        float64, through the camera bearings ``f_c`` (N, 3)."""
        return self.radiance(f_c, T_c_w).clamp(0, 255).to(torch.uint8)

    def radiance(self, f_c: torch.Tensor, T_c_w: torch.Tensor) -> torch.Tensor:
        """The textures' values (B, N) float32 that ``render`` stores."""
        R, t = T_c_w[:, :, :3], T_c_w[:, :, 3]
        f_w = torch.einsum("bji,nj->bni", R, f_c)               # R^T f
        t_w = (-R.transpose(1, 2) @ t[:, :, None])[:, None, :, 0].expand_as(f_w)
        lam, pidx = self.raycast(f_w, t_w)
        f_w, t_w, lam, pidx = f_w.reshape(-1, 3), t_w.reshape(-1, 3), lam.reshape(-1), \
            pidx.reshape(-1)
        out = torch.zeros(lam.shape, dtype=torch.float32, device=f_w.device)
        n = self.tex_size
        for i, pl in enumerate(self.planes):
            sel = (pidx == i).nonzero().squeeze(1)
            hit = t_w[sel] + lam[sel, None] * f_w[sel]
            rel = hit - pl["p0"]
            tu = ((rel @ pl["u"]) - pl["ur"][0]) / (pl["ur"][1] - pl["ur"][0]) * n
            tv = ((rel @ pl["v"]) - pl["vr"][0]) / (pl["vr"][1] - pl["vr"][0]) * n
            tu = tu.clamp(0, n - 1.001)
            tv = tv.clamp(0, n - 1.001)
            u0 = tu.to(torch.int64)
            v0 = tv.to(torch.int64)
            fu = (tu - u0).to(torch.float32)
            fv = (tv - v0).to(torch.float32)
            tex = pl["tex"]
            i00 = v0 * n + u0
            out[sel] = (tex[i00] * (1 - fu) * (1 - fv) + tex[i00 + 1] * fu * (1 - fv)
                        + tex[i00 + n] * (1 - fu) * fv + tex[i00 + n + 1] * fu * fv)
        return out.reshape(T_c_w.shape[0], -1)

    def render_frames(self, cam: Camera, poses: np.ndarray, chunk: int = 16,
                      photometry: Photometry | None = None) -> np.ndarray:
        """(N, H, W) uint8 host frames of ``poses`` (N, 3, 4) world→camera,
        rendered on the scene's device in chunks, through ``photometry``
        where it is given."""
        f_c = cam.pixel_bearings(self.device)
        T = torch.from_numpy(np.ascontiguousarray(poses, np.float64)).to(self.device)
        out = np.empty((len(poses), cam.height, cam.width), np.uint8)
        for a in range(0, len(poses), chunk):
            lum = self.radiance(f_c, T[a:a + chunk])
            if photometry is not None:
                lum = photometry.observe(lum, a)
            img = lum.clamp(0, 255).to(torch.uint8)
            out[a:a + chunk] = img.reshape(-1, cam.height, cam.width).cpu().numpy()
        return out

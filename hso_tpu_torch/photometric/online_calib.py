"""Online photometric calibration: camera response, vignette, exposure.

The port of the JAX package's ``hso_tpu/photometric/online_calib.py``
(Bergmann, Wang and Cremers, "Online Photometric Calibration of Auto Exposure
Video for Realtime Visual Odometry and SLAM", RA-L 2018).  Model:
O = f(e_j · V(r) · L_p), the observed intensity O of scene point p in frame j
with exposure e_j, vignette V at normalised radius r, radiance L_p, camera
response f.  With U = f⁻¹:

    log U(O_jp) = log e_j + log V(r_jp) + log L_p

  * log U(x) = log x + Σ_k c_k φ_k(x),  φ_k(x) = xᵏ(1-x) on x = O/255, so
    U(255) = 255 (scale gauge) and U is the identity for c = 0;
  * log V(R) = v₁R + v₂R² + v₃R³ on R = r²/r²_max, so V(0) = 1;
  * gauge: log e of the first frame = 0.

The joint problem is solved by masked alternating closed-form updates
(radiances, then exposures, then the response and vignette coefficients as a
(K+3)-dim ridge-regularised normal solve) with Huber IRLS weights: dense
masked tensor operations in float32, a fixed number of rounds, no host sync
inside.  ``OnlinePhotometricCalibrator`` is the host side: it samples the
tracked points' intensities from RAW frames, solves over a sliding window,
and linearises incoming frames on the device.
"""

from __future__ import annotations

import numpy as np
import torch

N_RESP = 4            #: response basis size
N_VIG = 3             #: vignette polynomial order in r²
INT_LO = 3.0          #: usable intensity range (saturation exclusion)
INT_HI = 252.0
_RIDGE = 1e-4


def _resp_basis(x_norm: torch.Tensor) -> torch.Tensor:
    """φ_k(x) = x^k (1-x), k=1..N_RESP → (..., N_RESP)."""
    return torch.stack([x_norm ** k * (1.0 - x_norm) for k in range(1, N_RESP + 1)], dim=-1)


def _vig_basis(r2_norm: torch.Tensor) -> torch.Tensor:
    """R^m, m=1..N_VIG → (..., N_VIG)."""
    return torch.stack([r2_norm ** m for m in range(1, N_VIG + 1)], dim=-1)


def log_inverse_response(intensity: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """log U(O) for O in [0, 255] (clamped to the usable range)."""
    x = torch.clamp(intensity, 1e-3, 255.0) / 255.0
    return torch.log(x * 255.0) + _resp_basis(x) @ c


def log_vignette(r2_norm: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return _vig_basis(r2_norm) @ v


def _masked_mean(x, w, dim):
    return torch.sum(x * w, dim=dim) / torch.clamp_min(torch.sum(w, dim=dim), 1e-9)


def _weighted_rms(r, w):
    return torch.sqrt(torch.sum(r * r * w) / torch.clamp_min(torch.sum(w), 1e-9))


def solve_photometric(obs_int: torch.Tensor, obs_r2: torch.Tensor, obs_valid: torch.Tensor,
                      n_rounds: int = 40, huber: float = 0.1) -> dict:
    """Alternating masked solve of the RA-L'18 energy on (F, M) tables of raw
    intensities, normalised squared radii in [0, 1] and a validity mask (all
    on one device; float32 arithmetic).

    Returns a dict of device tensors: c (N_RESP,), v (N_VIG,), log_e (F,),
    log_L (M,), rms_before, rms_after, n_obs.
    """
    obs_int = obs_int.to(torch.float32)
    obs_r2 = obs_r2.to(torch.float32)
    f_n, m_n = obs_int.shape
    dev = obs_int.device
    valid = obs_valid & (obs_int > INT_LO) & (obs_int < INT_HI)
    w_base = valid.to(torch.float32)

    phi = _resp_basis(torch.clamp(obs_int, 1e-3, 255.0) / 255.0)   # (F, M, K)
    psi = _vig_basis(obs_r2)                                       # (F, M, 3)
    log_o = torch.log(torch.clamp(obs_int, 1e-3, 255.0))
    A = torch.cat([phi, -psi], dim=-1)                             # (F, M, K+3)
    ridge = _RIDGE * torch.eye(N_RESP + N_VIG, dtype=torch.float32, device=dev)

    def residual(c, v, log_e, log_l):
        lu = log_o + phi @ c
        return lu - (psi @ v) - log_e[:, None] - log_l[None, :]

    c = torch.zeros((N_RESP,), dtype=torch.float32, device=dev)
    v = torch.zeros((N_VIG,), dtype=torch.float32, device=dev)
    log_e = torch.zeros((f_n,), dtype=torch.float32, device=dev)
    log_l = torch.sum(log_o * w_base, 0) / torch.clamp_min(torch.sum(w_base, 0), 1e-9)
    rms_before = _weighted_rms(residual(c, v, log_e, log_l), w_base)
    for _ in range(n_rounds):
        # Huber IRLS weights from the current residual
        r = residual(c, v, log_e, log_l)
        w = w_base * torch.clamp_max(huber / torch.clamp_min(torch.abs(r), 1e-9), 1.0)
        lu = log_o + phi @ c
        lv = psi @ v
        # 1. radiances
        log_l = _masked_mean(lu - lv - log_e[:, None], w, 0)
        # 2. exposures (gauge: first frame = 0)
        log_e = _masked_mean(lu - lv - log_l[None, :], w, 1)
        log_e = log_e - log_e[0]
        # 3. response + vignette coefficients: joint (K+3) ridge LS on
        #    Φc - Ψv = y,  y = log_e + log_L - log O
        y = log_e[:, None] + log_l[None, :] - log_o
        Aw = A * w[..., None]
        H = torch.einsum("fmi,fmj->ij", Aw, A) + ridge
        g = torch.einsum("fmi,fm->i", Aw, y)
        sol = torch.linalg.solve_ex(H, g)[0]     # no error check: no host sync
        c, v = sol[:N_RESP], sol[N_RESP:]
    rms_after = _weighted_rms(residual(c, v, log_e, log_l), w_base)
    return {"c": c, "v": v, "log_e": log_e, "log_L": log_l,
            "rms_before": rms_before, "rms_after": rms_after, "n_obs": torch.sum(w_base)}


def correct_image(img: torch.Tensor, c: torch.Tensor, v: torch.Tensor,
                  r2_norm_img: torch.Tensor) -> torch.Tensor:
    """Photometrically linearise a frame:  I_corr = U(I) / V(r) · g, on the
    device of ``img``, float32.

    The gauge factor g = 128 / U(128) keeps mid-grey fixed (the model's scale
    gauge is U(255) = 255); the tracker's exposure-ratio estimate absorbs the
    global gain.  I = 0 maps to 0; the output is clipped to [0, 255].
    """
    img_f = img.to(torch.float32)
    lu = log_inverse_response(img_f, c)
    lv = log_vignette(r2_norm_img, v)
    lg = float(np.log(np.float32(128.0))) - log_inverse_response(
        torch.full((), 128.0, dtype=torch.float32, device=img_f.device), c)
    out = torch.exp(lu - lv + lg)
    out = torch.where(img_f <= 0.0, torch.zeros_like(out), out)
    return torch.clamp(out, 0.0, 255.0)


def inverse_response_curve(c, n: int = 256) -> np.ndarray:
    """U over [0, 255] as a host array (diagnostics, export)."""
    x = torch.linspace(0.0, 255.0, n, dtype=torch.float32)
    u = torch.exp(log_inverse_response(x, torch.tensor(np.asarray(c, np.float32))))
    return torch.where(x <= 0.0, torch.zeros_like(u), u).numpy()


def _r2_max(width: int, height: int, cx: float, cy: float) -> float:
    """The largest squared corner radius about (cx, cy)."""
    return max(
        (0 - cx) ** 2 + (0 - cy) ** 2,
        (width - 1 - cx) ** 2 + (0 - cy) ** 2,
        (0 - cx) ** 2 + (height - 1 - cy) ** 2,
        (width - 1 - cx) ** 2 + (height - 1 - cy) ** 2,
    )


def _r2_image(height: int, width: int, cx: float, cy: float) -> np.ndarray:
    """Squared radius over the image plane, normalised by the corner radius
    (float64)."""
    yy, xx = np.mgrid[0:height, 0:width]
    return ((xx - cx) ** 2 + (yy - cy) ** 2) / _r2_max(width, height, cx, cy)


def vignette_map(v, height: int, width: int, cx: float, cy: float) -> np.ndarray:
    """V(r) over the image plane, normalised by the largest corner radius."""
    r2n = torch.from_numpy(_r2_image(height, width, cx, cy).astype(np.float32))
    return torch.exp(log_vignette(r2n, torch.tensor(np.asarray(v, np.float32)))).numpy()


class OnlinePhotometricCalibrator:
    """Host-side orchestration: sample tracked-point intensities from raw
    frames, run :func:`solve_photometric` over a sliding window every
    ``solve_every`` frames, and linearise incoming images with the current
    estimate on ``device`` (the card unless the caller asks for the CPU).

    Observations come from RAW images, so the estimate does not compound
    with the applied correction.
    """

    def __init__(self, cam, window: int = 48, solve_every: int = 16,
                 min_frames: int = 12, max_points: int = 384, device="cuda"):
        self.cam = cam
        self.device = torch.device(device)
        self.window = window
        self.solve_every = solve_every
        self.min_frames = min_frames
        self.max_points = max_points
        self.cx, self.cy = float(cam.cx), float(cam.cy)
        self.r2_max = _r2_max(cam.width, cam.height, self.cx, self.cy)
        self._r2_img = torch.from_numpy(
            _r2_image(cam.height, cam.width, self.cx, self.cy).astype(np.float32)
        ).to(self.device)
        self.frames: list[dict] = []   # each: {pid: (M,), inten: (M,), r2: (M,)}
        self.c = np.zeros(N_RESP, np.float32)
        self.v = np.zeros(N_VIG, np.float32)
        self.calibrated = False
        self.last_rms = (0.0, 0.0)
        self._since_solve = 0
        self._cv_dev = None            # (c, v) on the device, made once a solve adopts

    # ---------------------------------------------------------------- ingest
    def add_frame_samples(self, raw_img, obs: dict) -> None:
        """Record raw intensities of this frame's matched points.

        ``raw_img`` is the uncorrected uint8 or float image (numpy or tensor);
        ``obs`` the frame's host observation table (px, point_id, valid).
        """
        sel = obs["valid"] & (obs["point_id"] >= 0)
        if sel.sum() < 8:
            return
        if isinstance(raw_img, torch.Tensor):
            raw_img = raw_img.cpu().numpy()
        px = obs["px"][sel]
        u = np.clip(px[:, 0], 0, raw_img.shape[1] - 2)
        v = np.clip(px[:, 1], 0, raw_img.shape[0] - 2)
        u0 = u.astype(np.int64)
        v0 = v.astype(np.int64)
        fu = (u - u0).astype(np.float32)
        fv = (v - v0).astype(np.float32)
        img = raw_img.astype(np.float32)
        inten = (
            img[v0, u0] * (1 - fu) * (1 - fv)
            + img[v0, u0 + 1] * fu * (1 - fv)
            + img[v0 + 1, u0] * (1 - fu) * fv
            + img[v0 + 1, u0 + 1] * fu * fv
        )
        r2 = ((px[:, 0] - self.cx) ** 2 + (px[:, 1] - self.cy) ** 2) / self.r2_max
        self.frames.append({
            "pid": obs["point_id"][sel].copy(),
            "inten": inten,
            "r2": r2.astype(np.float32),
        })
        if len(self.frames) > self.window:
            self.frames.pop(0)
        self._since_solve += 1
        if self._since_solve >= self.solve_every and len(self.frames) >= self.min_frames:
            self.solve()
            self._since_solve = 0

    # ----------------------------------------------------------------- solve
    def problem(self):
        """The window's (F, M) tables (intensities, r², valid) over the points
        seen in ≥ 3 frames, most-observed first; None below 16 such points."""
        counts: dict[int, int] = {}
        for fr in self.frames:
            for p in fr["pid"]:
                counts[int(p)] = counts.get(int(p), 0) + 1
        pids = [p for p, n in counts.items() if n >= 3]
        if len(pids) < 16:
            return None
        pids.sort(key=lambda p: -counts[p])
        pids = pids[: self.max_points]
        col = {p: i for i, p in enumerate(pids)}

        f_n, m_n = len(self.frames), len(pids)
        inten = np.zeros((f_n, m_n), np.float32)
        r2 = np.zeros((f_n, m_n), np.float32)
        valid = np.zeros((f_n, m_n), bool)
        for j, fr in enumerate(self.frames):
            for p, o, r in zip(fr["pid"], fr["inten"], fr["r2"]):
                i = col.get(int(p))
                if i is not None:
                    inten[j, i] = o
                    r2[j, i] = r
                    valid[j, i] = True
        return inten, r2, valid

    def solve(self) -> dict | None:
        if len(self.frames) < self.min_frames:
            return None
        prob = self.problem()
        if prob is None:
            return None
        out = solve_photometric(*(self._upload(a) for a in prob))
        keys = list(out)
        flat = torch.cat([out[k].reshape(-1) for k in keys]).cpu().numpy()   # one copy
        res, off = {}, 0
        for k in keys:
            n = out[k].numel()
            res[k] = flat[off:off + n].reshape(tuple(out[k].shape))
            off += n
        c_new, v_new = res["c"], res["v"]
        rms_b, rms_a = float(res["rms_before"]), float(res["rms_after"])
        self.last_rms = (rms_b, rms_a)
        # adoption gates: a mis-fit must never poison tracking.  Require a
        # finite fit, clearly better than the identity model, with a small
        # residual, a vignette within [0.25, 1.3] at the corners, and an
        # inverse response of bounded deviation (|Σ c φ| < 1.2 in log space),
        # strictly monotone, with a bounded ratio of slopes (oscillating
        # runaway fits have negative or wildly varying slopes long before
        # their residual degrades)
        ok = (np.all(np.isfinite(c_new)) and np.all(np.isfinite(v_new))
              and rms_a < 0.85 * rms_b and rms_a < 0.15)
        if ok:
            x = np.linspace(0.05, 0.99, 64)
            resp_dev = sum(c_new[k - 1] * x ** k * (1 - x)
                           for k in range(1, N_RESP + 1))
            vig_corner = np.exp(np.sum(v_new * np.ones(N_VIG)))
            log_u = np.log(x) + resp_dev
            du = np.diff(log_u) / np.diff(np.log(x))   # d logU / d log x
            ok = (np.max(np.abs(resp_dev)) < 1.2
                  and 0.25 < vig_corner < 1.3
                  and np.all(du > 0.05)
                  and np.max(du) / max(np.min(du), 1e-6) < 25.0)
        if ok:
            if self.calibrated:
                # smooth coefficient updates: a jump in the applied response
                # looks like a global illumination step to the tracker
                self.c = 0.7 * self.c + 0.3 * c_new
                self.v = 0.7 * self.v + 0.3 * v_new
            else:
                self.c, self.v = c_new, v_new
            self.calibrated = True
            self._cv_dev = None
        return res

    # ---------------------------------------------------------------- apply
    def correct(self, img):
        """The linearised image (float32 tensor on the calibrator's device);
        the input unchanged until calibrated."""
        if not self.calibrated:
            return img
        if self._cv_dev is None:
            cv = self._upload(np.concatenate([self.c, self.v]).astype(np.float32))
            self._cv_dev = (cv[:N_RESP], cv[N_RESP:])
        img = img.to(self.device) if isinstance(img, torch.Tensor) else self._upload(img)
        return correct_image(img, *self._cv_dev, self._r2_img)

    def _upload(self, a) -> torch.Tensor:
        """A host array on the calibrator's device; on the card a non-blocking
        copy from pinned memory, so the host does not wait."""
        t = torch.from_numpy(np.array(a, copy=True))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

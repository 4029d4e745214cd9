"""Shared makers of test inputs (numpy only).

Every function here takes a seed or deterministic arguments and returns plain
numpy arrays, so the same inputs can be handed to this package and to the
JAX package it was ported from.
"""

from __future__ import annotations

import numpy as np

from hso_tpu_torch.math import se3np

PT_WIN = 24


def window_anchor_cases(h: int, w: int, win: int, n_random: int, seed: int):
    """Integer anchors for window extraction: the four image corners, then
    ``n_random`` interior anchors.  Returns int32 (au, av)."""
    rs = np.random.RandomState(seed)
    au = np.concatenate([[0, w - win, 0, w - win], rs.randint(0, w - win, n_random)])
    av = np.concatenate([[0, 0, h - win, h - win], rs.randint(0, h - win, n_random)])
    return au.astype(np.int32), av.astype(np.int32)


def level_center_cases(level_shapes, s: int, seed: int, margin: float = 5.0):
    """Per-row pyramid levels and window centres in each row's own level
    coordinates, some of them outside the image (the anchor clip has to
    bring them back).  Returns (level int32, cu float32, cv float32)."""
    rs = np.random.RandomState(seed)
    level = rs.randint(0, len(level_shapes), s).astype(np.int32)
    cu = np.empty(s, np.float32)
    cv = np.empty(s, np.float32)
    for k in range(s):
        h, w = level_shapes[level[k]]
        cu[k] = rs.uniform(-margin, w + margin)
        cv[k] = rs.uniform(-margin, h + margin)
    return level, cu, cv


def pad_features(px, f, dist, n_max: int):
    """Pad a feature list to ``n_max`` slots; empty slots carry dist = -1."""
    n = len(px)
    px_p = np.zeros((n_max, 2), np.float32)
    f_p = np.zeros((n_max, 3), np.float32)
    f_p[:, 2] = 1.0
    d_p = np.full((n_max,), -1.0, np.float32)
    px_p[:n], f_p[:n], d_p[:n] = px, f, dist
    return px_p, f_p, d_p


def align_problem(level_shapes, sample_patch, s: int = 64, seed: int = 2):
    """Alignment candidates mixing corners/edgelets, border/far/invalid rows,
    on mixed pyramid levels.  ``sample_patch(level, cu, cv) -> (10, 10)``
    reads the bordered template around a true position at a level.

    Row 0 sits near the image border, row 1 has its patch outside the image
    (must fail), row 2 is a dead slot, row 3 starts hopelessly far away
    (must not converge)."""
    rs = np.random.RandomState(seed)
    n_levels = len(level_shapes)
    level = rs.randint(0, n_levels, s).astype(np.int32)
    px_true = np.empty((s, 2), np.float32)
    for k in range(s):
        h, w = level_shapes[level[k]]
        px_true[k] = [rs.uniform(16, w - 16), rs.uniform(16, h - 16)]
    px_true[0] = [8.2, 8.7]
    px_true[1] = [2.0, 2.0]
    is_edge = rs.rand(s) < 0.3
    theta = rs.uniform(0, 2 * np.pi, s).astype(np.float32)
    direction = np.stack([np.cos(theta), np.sin(theta)], -1).astype(np.float32)
    valid = np.ones(s, bool)
    valid[2] = False
    offset = rs.uniform(-1.2, 1.2, (s, 2)).astype(np.float32)
    offset[3] = [30.0, -28.0]
    px_init = (px_true + offset).astype(np.float32)
    ref_border = np.stack([sample_patch(int(level[k]), float(px_true[k, 0]),
                                        float(px_true[k, 1])) for k in range(s)])
    return dict(level=level, is_edge=is_edge, direction=direction, valid=valid,
                px_init=px_init, px_true=px_true, ref_border=ref_border.astype(np.float32))


def bilinear_patch(img: np.ndarray, cu: float, cv: float, size: int = 10) -> np.ndarray:
    """(size, size) bilinear patch of ``img`` whose grid point (0, 0) sits at
    (cu - size/2, cv - size/2); reads outside the image are 0."""
    h, w = img.shape
    g = np.arange(size, dtype=np.float64) - size / 2
    xs = cu + g[None, :] + np.zeros((size, 1))
    ys = cv + g[:, None] + np.zeros((1, size))
    x0 = np.floor(xs).astype(np.int64)
    y0 = np.floor(ys).astype(np.int64)
    fx, fy = xs - x0, ys - y0

    def tap(xi, yi):
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        return np.where(inside, img[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)], 0.0)

    out = (tap(x0, y0) * (1 - fx) * (1 - fy) + tap(x0 + 1, y0) * fx * (1 - fy)
           + tap(x0, y0 + 1) * (1 - fx) * fy + tap(x0 + 1, y0 + 1) * fx * fy)
    return out.astype(np.float32)


def pose_problem(n: int = 256, n_live: int = 180, seed: int = 11):
    """A motion-only pose problem: ``n`` slots, the first ``n_live`` valid,
    noisy bearings of points seen from ``T_true``, one gross outlier at slot
    ``n_live - 3``.  The initial pose is the identity."""
    rs = np.random.RandomState(seed)
    p_world = np.stack([rs.uniform(-2, 2, n), rs.uniform(-1.5, 1.5, n),
                        rs.uniform(1.5, 4.0, n)], -1).astype(np.float32)
    T_true = se3np.exp(np.array([0.05, -0.02, 0.03, 0.01, 0.02, -0.015]))
    p_c = (T_true[:3, :3] @ p_world.T).T + T_true[:3, 3]
    f_obs = p_c / np.linalg.norm(p_c, axis=-1, keepdims=True)
    f_obs += rs.normal(0, 5e-4, f_obs.shape)
    f_obs[n_live - 3, 0] += 0.1
    f_obs /= np.linalg.norm(f_obs, axis=-1, keepdims=True)
    level = rs.randint(0, 3, n).astype(np.int32)
    theta = rs.uniform(0, 2 * np.pi, n)
    grad = np.stack([np.cos(theta), np.sin(theta)], -1).astype(np.float32)
    return dict(T0=se3np.identity().astype(np.float32), T_true=T_true, p_world=p_world,
                f_obs=f_obs.astype(np.float32), level=level, grad=grad,
                is_edge=rs.rand(n) < 0.3, is_temp=rs.rand(n) < 0.1,
                valid=np.arange(n) < n_live)


def track_problem(cam, scene, T_cur, p_max: int = 512, grid_step: int = 12,
                  border: int = 20, seed: int = 5):
    """A two-view tracking problem on a synthetic scene with ground-truth
    depths: the previous frame is a keyframe at the identity, the current
    frame is rendered at ``T_cur``.

    Returns a dict of numpy arrays: the two images, a hand-built point table
    (``pos_w``, ``light``, ``species``, and the per-point columns of
    ``pt_pack`` after the window: ``cols`` (P, 12)), ``kf_poses``,
    ``kf_exposure``, ``ring_T``, ``ring_exp`` and the previous frame's
    observation table.  The caller extracts each point's 24×24 window at
    ``px`` on level 0 and prepends it to ``cols`` to form ``pt_pack``."""
    rs = np.random.RandomState(seed)
    img_prev = scene.render(se3np.identity())
    img_cur = scene.render(T_cur)
    px, f, dist = scene.grid_features(step=grid_step, border=border)
    n = min(len(px), p_max)
    px, f, dist = px[:n].astype(np.float32), f[:n].astype(np.float32), dist[:n]

    # gradient direction at each feature (central differences of the image)
    im = img_prev.astype(np.float32)
    xi = px[:, 0].astype(np.int64)
    yi = px[:, 1].astype(np.int64)
    g = np.stack([im[yi, xi + 1] - im[yi, xi - 1], im[yi + 1, xi] - im[yi - 1, xi]], -1)
    gnorm = np.linalg.norm(g, axis=-1, keepdims=True)
    grad = np.where(gnorm > 1e-6, g / np.maximum(gnorm, 1e-6), np.array([[1.0, 0.0]]))

    species = np.zeros(p_max, np.int32)
    species[:n] = rs.choice([0, 1, 2], size=n, p=[0.6, 0.25, 0.15])
    pt_type = np.zeros(p_max, np.int32)
    pt_type[:n] = rs.choice([1, 2, 3, 4], size=n, p=[0.1, 0.3, 0.3, 0.3])
    pt_valid = np.arange(p_max) < n

    pos_w = np.zeros((p_max, 3), np.float32)
    pos_w[:n] = f * dist[:, None]
    anchor = np.zeros((p_max, 2), np.int32)
    anchor[:n, 0] = np.clip(np.floor(px[:, 0]).astype(np.int64) - PT_WIN // 2, 0,
                            cam.width - PT_WIN)
    anchor[:n, 1] = np.clip(np.floor(px[:, 1]).astype(np.int64) - PT_WIN // 2, 0,
                            cam.height - PT_WIN)
    cols = np.zeros((p_max, 12), np.float32)
    cols[:n, 0:2] = px
    cols[:, 2:5] = [0.0, 0.0, 1.0]
    cols[:n, 2:5] = f
    cols[:, 5:7] = anchor
    cols[:n, 8:10] = grad
    cols[:, 10] = species
    px_full = np.zeros((p_max, 2), np.float32)
    px_full[:n] = px

    n_kf = 4
    kf_poses = np.tile(se3np.identity()[None], (n_kf, 1, 1)).astype(np.float32)
    # previous frame's observations: every third point, the rest empty slots
    obs_ids = np.arange(0, n, 3)
    n_obs = len(obs_ids)
    return dict(
        img_prev=img_prev, img_cur=img_cur, n_points=n, px=px_full, cols=cols, anchor=anchor,
        pos_w=pos_w, species=species, light=(pt_type + 8 * pt_valid).astype(np.int32),
        kf_poses=kf_poses, kf_exposure=np.ones(n_kf, np.float32),
        ring_T=np.tile(se3np.identity()[None], (8, 1, 1)).astype(np.float32),
        ring_exp=np.ones(8, np.float32),
        obs_px=px[obs_ids], obs_f=f[obs_ids], obs_pid=obs_ids.astype(np.int32), n_obs=n_obs,
    )


def epipolar_problem(level_shapes, s: int = 48, seed: int = 7, margin: float = 30.0):
    """Epipolar segments on mixed pyramid levels: centres inside the image,
    random directions and half-lengths up to 16 px.

    Row 0 has its window clipped at the image corner, row 1 a zero-length
    segment, row 2 is a dead slot.  Returns a dict of level (int32), center,
    px_far, px_close (float32, level coordinates) and valid."""
    rs = np.random.RandomState(seed)
    n_levels = len(level_shapes)
    level = rs.randint(0, n_levels, s).astype(np.int32)
    center = np.empty((s, 2), np.float32)
    for k in range(s):
        h, w = level_shapes[level[k]]
        center[k] = [rs.uniform(margin, w - margin), rs.uniform(margin, h - margin)]
    center[0] = [6.0, 6.0]
    theta = rs.uniform(0, 2 * np.pi, s)
    d = np.stack([np.cos(theta), np.sin(theta)], -1).astype(np.float32)
    half = rs.uniform(0.0, 16.0, s).astype(np.float32)
    half[1] = 0.0
    valid = np.ones(s, bool)
    valid[2] = False
    return dict(level=level, center=center, valid=valid,
                px_far=(center - d * half[:, None]).astype(np.float32),
                px_close=(center + d * half[:, None]).astype(np.float32))


def line_score_cases(s: int = 24, ew: int = 48, n_steps: int = 40, seed: int = 0,
                     img_hw=(240, 320)):
    """Direct inputs of the ZMNCC line-score kernel on noise windows whose
    template is a true 8×8 crop (a real correlation peak), with adversarial
    rows (``s`` ≥ 5): 0 a low-contrast window, 1 a segment wholly outside the
    window, 2 a segment ending exactly on the last map column, 3 a window
    at the image corner (patches leave the image), 4 a zero direction.
    Returns a dict of numpy arrays in the kernel's argument order."""
    rs = np.random.RandomState(seed)
    ow = ew - 7
    h, w = img_hw
    windows = rs.uniform(0, 255, (s, ew, ew)).astype(np.float32)
    windows[0] = 100.0 + windows[0] * (30.0 / 255.0)
    cy = rs.randint(0, ow, s)
    cx = rs.randint(0, ow, s)
    ref = np.stack([windows[k, cy[k]:cy[k] + 8, cx[k]:cx[k] + 8] for k in range(s)])
    gain, offset = rs.uniform(0.5, 1.5, (s, 1, 1)), rs.uniform(-20, 20, (s, 1, 1))
    ref = (ref * gain + offset).astype(np.float32)
    theta = rs.uniform(0, 2 * np.pi, s)
    du, dv = np.cos(theta).astype(np.float32), np.sin(theta).astype(np.float32)
    n_line = rs.randint(4, n_steps, s).astype(np.int32)
    k0 = rs.randint(0, 8, s)
    su0 = (cx - du * k0).astype(np.float32)
    sv0 = (cy - dv * k0).astype(np.float32)
    au = rs.randint(0, w - ew, s).astype(np.int32)
    av = rs.randint(0, h - ew, s).astype(np.int32)
    su0[1], sv0[1], du[1], dv[1] = -60.0, 5.0, -1.0, 0.0
    su0[2], sv0[2], du[2], dv[2], n_line[2] = float(ow - 1 - 10), 3.0, 1.0, 0.0, 10
    au[3], av[3] = 0, 0
    su0[3], sv0[3], du[3], dv[3] = 0.0, 0.0, 0.5, 0.5
    du[4], dv[4] = 0.0, 0.0
    return dict(windows=windows, ref_patch=ref, su0=su0, sv0=sv0, dir_u=du, dir_v=dv,
                n_line=n_line, au=au, av=av, hs=np.full(s, h, np.int32),
                ws=np.full(s, w, np.int32))


# ------------------------------------------------------------------ detection
def corner_test_image(h: int = 240, w: int = 320, step: int = 40) -> np.ndarray:
    """Bright squares on dark: strong unambiguous corners (float32)."""
    img = np.full((h, w), 30, np.float32)
    for y in range(20, h - step, step):
        for x in range(20, w - step, step):
            img[y:y + step // 2, x:x + step // 2] = 220.0
    return img


def stripe_image(h: int = 240, w: int = 320, period: int = 24) -> np.ndarray:
    """Diagonal stripes: edgelets whose normals lie along ±(1, 1)/√2 (uint8)."""
    yy, xx = np.mgrid[0:h, 0:w]
    return (127 + 120 * np.sign(np.sin((xx + yy) * 2 * np.pi / period))).astype(np.uint8)


def low_texture_texture(size: int = 1024) -> np.ndarray:
    """Smooth sinusoidal shading: no FAST corner and no edgelet at any level,
    only the gradient species (a texture for ``PlaneScene``)."""
    yy, xx = np.mgrid[0:size, 0:size]
    return 127 + 8.0 * np.sin(2 * np.pi * xx / 300) * np.sin(2 * np.pi * yy / 300)


# ------------------------------------------------------------------ bundle adjustment
def ba_problem(n_kf: int = 6, n_pts: int = 120, seed: int = 0, noise_px: float = 0.0,
               edge_frac: float = 0.25, pose_pert: float = 0.01, idist_pert: float = 0.05,
               K: int = 8, P: int = 256, focal: float = 450.0) -> dict:
    """A synthetic windowed BA with known ground truth in the solver's dense
    (P, K) observation-grid layout: a ring of ``n_kf`` keyframes around a
    point cloud, every point seen by every keyframe but its host, keyframes
    0 and 1 held fixed (the monocular gauge), the others and the inverse
    distances perturbed.  Returns numpy arrays (``obs`` a dict)."""
    assert n_kf <= K and n_pts <= P
    rng = np.random.default_rng(seed)
    T_gt = np.stack([se3np.exp(np.r_[rng.uniform(-0.4, 0.4, 2), 0.05 * k,
                                     rng.uniform(-0.05, 0.05, 3)]) for k in range(n_kf)])
    p_w = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-2, 2, n_pts),
                    rng.uniform(4, 8, n_pts)], axis=-1)
    host = rng.integers(0, n_kf, n_pts)
    p_h = np.einsum("nij,nj->ni", T_gt[host][:, :3, :3], p_w) + T_gt[host][:, :3, 3]
    dist = np.linalg.norm(p_h, axis=-1)
    idist_gt = 1.0 / dist

    obs = {"meas": np.zeros((P, K, 2), np.float32), "grad": np.zeros((P, K, 2), np.float32),
           "is_edgelet": np.zeros((P, K), bool), "level": np.zeros((P, K), np.int32),
           "valid": np.zeros((P, K), bool), "f_host": np.zeros((P, 3), np.float32),
           "host": np.zeros(P, np.int32)}
    for k in range(n_kf):
        p_k = np.einsum("ij,nj->ni", T_gt[k][:3, :3], p_w) + T_gt[k][:3, 3]
        for p in range(n_pts):
            if k == host[p] or p_k[p, 2] < 0.1:
                continue
            obs["meas"][p, k] = p_k[p, :2] / p_k[p, 2] + rng.normal(0, noise_px / focal, 2)
            g = rng.normal(size=2)
            obs["grad"][p, k] = g / np.linalg.norm(g)
            obs["is_edgelet"][p, k] = rng.uniform() < edge_frac
            obs["level"][p, k] = rng.integers(0, 3)
            obs["valid"][p, k] = True
    obs["f_host"][:n_pts] = p_h / dist[:, None]
    obs["host"][:n_pts] = host

    T_init = T_gt.copy()
    for k in range(2, n_kf):
        T_init[k] = se3np.mul(se3np.exp(rng.normal(0, pose_pert, 6)), T_gt[k])
    T_kf = np.tile(se3np.identity().astype(np.float32), (K, 1, 1))
    T_kf[:n_kf] = T_init
    free = np.zeros(K, bool)
    free[2:n_kf] = True
    idist = np.zeros(P, np.float32)
    idist[:n_pts] = idist_gt * (1.0 + rng.normal(0, idist_pert, n_pts))
    point_valid = np.zeros(P, bool)
    point_valid[:n_pts] = True
    return dict(T_gt=T_gt, idist_gt=idist_gt, obs=obs, T_kf=T_kf, free=free, idist=idist,
                point_valid=point_valid, n_kf=n_kf, n_pts=n_pts, K=K, P=P)


#: the synthetic camera's photometric distortion (a numpy copy of
#: tests/test_pipeline_photometric.py's): response gamma, vignette
#: coefficients of log V in R and R² (R = r²/r²_max)
PHOTO_GAMMA = 0.75
PHOTO_VIG = (-0.35, -0.15)


def photo_r2n(height: int = 480, width: int = 640, cx: float = 320.0,
              cy: float = 240.0) -> np.ndarray:
    """R = r² / r²(corner (0, 0)) over the image plane, float64."""
    yy, xx = np.mgrid[0:height, 0:width]
    return ((xx - cx) ** 2 + (yy - cy) ** 2) / ((0 - cx) ** 2 + (0 - cy) ** 2)


def exposure_walk(n: int, seed: int = 4) -> np.ndarray:
    """A smooth bounded auto-exposure walk: log e per frame, log e[0] = 0."""
    rng = np.random.default_rng(seed)
    log_e = np.cumsum(rng.uniform(-0.06, 0.06, n))
    return np.clip(log_e - log_e[0], -0.3, 0.3)


def photo_distort(img: np.ndarray, log_e: float, r2n: np.ndarray) -> np.ndarray:
    """What the distorted camera records of a rendered frame (float64):
    exposure, vignette, clip to [0, 255], then the response curve."""
    v_fac = np.exp(PHOTO_VIG[0] * r2n + PHOTO_VIG[1] * r2n ** 2)
    y = np.clip(np.exp(log_e) * v_fac * img, 0.0, 255.0)
    return 255.0 * (y / 255.0) ** PHOTO_GAMMA


def exposure_gauge(log_e: np.ndarray, log_e_ref: np.ndarray) -> tuple:
    """(alpha, max |log_e - alpha·log_e_ref|), alpha by least squares.

    The photometric model is self-consistent under U^α, e^α, V^α (the gamma
    ambiguity), and on real samples float32 rounding alone moves a solve
    along it: two solves of the same samples are compared modulo alpha."""
    ref = np.asarray(log_e_ref, np.float64)
    alpha = float(np.dot(np.asarray(log_e, np.float64), ref) / max(np.dot(ref, ref), 1e-30))
    return alpha, float(np.abs(np.asarray(log_e, np.float64) - alpha * ref).max())

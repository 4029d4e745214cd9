"""Probabilistic depth filter: per-seed recursive inverse-depth estimation.

The whole sweep is one batched pass over a static seed table:

  * seeds are SoA slot tensors (masked), hosts referenced through a small ring
    of recent keyframes,
  * each seed stores a window of its host image, extracted once at seed
    creation — per-frame affine re-warping of the reference patch then needs
    no host-image access at all,
  * the ±2σ inverse-depth range projects to an epipolar segment; matching is
    the dense ZMNCC line search (``ops/epipolar.py``, kernel K6) + batched
    alignment (``ops/align_cuda.py``, kernel K4) on level-packed windows
    (kernel K2),
  * measurement fusion is an inverse-variance update with a triangulation
    uncertainty from a one-pixel bearing error,
  * seed lifecycle (creation from detections, aging after ``max_batches``
    keyframe batches, convergence harvesting at √σ² < z_range/converge_thresh)
    is slot allocation with masks.

``update_mask`` restricts a sweep to a subset (the backfill of the newest
seed batch from retained earlier frames); the multi-view activation
refinement over each seed's observation ring is :func:`_activation_refine`.

Every function returns new tensors and leaves its inputs untouched, so a
sweep can be repeated from the same state.
"""

from __future__ import annotations

import math

import torch

from hso_tpu_torch.math import se3
from hso_tpu_torch.math.linalg_small import inv2x2
from hso_tpu_torch.ops.align_cuda import (ROW_CONV, ROW_GX, ROW_GY, ROW_NCC, ROW_U, ROW_V,
                                          align_match)
from hso_tpu_torch.ops.epipolar import (EW, MAX_EPL, epipolar_zmncc_search, pack_level_windows,
                                        triangulate_depth)
from hso_tpu_torch.ops.warp import (best_search_level, memoize_level_windows,
                                    warp_from_stored_windows, warp_matrices)

HOST_WIN = 44          #: stored host-image window edge.  Sized so the 10×10
#: bordered ref patch stays inside even when the epipolar search runs two
#: levels coarser than the seed's own level (±5·2² px + bilinear tap); the
#: point table keeps compact 24 px windows.
N_OBS_RING = 8         #: per-seed observation ring for activation refinement
SEED_FIELDS = (
    "valid", "host", "px", "f", "level", "species", "grad",
    "mu", "sigma2", "a", "b", "z_range", "converge_thresh", "batch_id",
    "host_win", "host_anchor",
)
EDGELET = 1
GRADIENT = 2


def empty_seeds(s_max: int, device="cuda") -> dict:
    dev = torch.device(device)

    def z(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return {
        "valid": z((s_max,), torch.bool),
        "host": z((s_max,), torch.int32),
        "px": z((s_max, 2)),
        "f": z((s_max, 3)),
        "level": z((s_max,), torch.int32),
        "species": z((s_max,), torch.int32),
        "grad": z((s_max, 2)),
        "mu": z((s_max,)), "sigma2": z((s_max,)), "a": z((s_max,)), "b": z((s_max,)),
        "z_range": z((s_max,)), "converge_thresh": z((s_max,)),
        "batch_id": z((s_max,), torch.int32),
        "host_win": z((s_max, HOST_WIN, HOST_WIN)),
        "host_anchor": z((s_max, 2), torch.int32),
        "n_updates": z((s_max,)),   # per-seed successful observation count
        # observation ring for multi-view activation refinement
        "obs_uv": z((s_max, N_OBS_RING, 2)),
        "obs_T": z((s_max, N_OBS_RING, 3, 4)),
        "obs_valid": z((s_max, N_OBS_RING), torch.bool),
        "obs_count": z((s_max,), torch.int32),
        # TEMPORARY map point spawned from this seed, -1 none
        "temp_point": torch.full((s_max,), -1, dtype=torch.int32, device=dev),
    }


def init_seeds(seeds, det, kf_pyr, f_det, host_slot, batch_id, depth_mean, depth_min,
               converge_thresh, n_levels: int = 3):
    """Allocate seed slots for new detections.

    ``det`` is a detection dict (px/level/species/grad/valid), ``kf_pyr`` the
    new keyframe's pyramid, ``f_det`` (N, 3) the detections' bearings,
    ``host_slot`` the keyframe's ring slot, ``batch_id`` the keyframe batch
    counter, ``depth_mean``/``depth_min`` the scene-depth prior."""
    dev = seeds["valid"].device
    s_max = seeds["valid"].shape[0]
    n_det = det["px"].shape[0]
    f32, i32 = torch.float32, torch.int32

    # stored host windows at each detection's own level
    px = det["px"].to(f32)
    win, anch = memoize_level_windows(kf_pyr, px, det["level"], win=HOST_WIN, n_levels=n_levels)

    # slot allocation: free slots first, in slot order (stable sort of the
    # valid flag: False < True)
    order = torch.sort(seeds["valid"].to(i32), stable=True).indices
    n_free = torch.sum(~seeds["valid"])
    ar = torch.arange(n_det, device=dev)
    take = (ar < n_free) & det["valid"]
    slot = order[ar % s_max]

    def scalar(x):
        return torch.as_tensor(x, dtype=f32, device=dev).reshape(())

    mu0 = 1.0 / torch.clamp_min(scalar(depth_mean), 1e-6)
    zr0 = 1.0 / torch.clamp_min(scalar(depth_min), 1e-6)
    sig0 = zr0 * zr0 / 36.0

    def full(value, dtype=f32):
        if not isinstance(value, torch.Tensor):       # a fill, not a copy from the host
            return torch.full((n_det,), value, dtype=dtype, device=dev)
        return value.to(dev).to(dtype).reshape(()).expand(n_det)

    assign = {
        "valid": torch.ones((n_det,), dtype=torch.bool, device=dev),
        "host": full(host_slot, i32),
        "px": px,
        "f": f_det.to(f32),
        "level": det["level"].to(i32),
        "species": det["species"].to(i32),
        "grad": det["grad"].to(f32),
        "mu": full(mu0),
        "sigma2": full(sig0),
        "a": full(10.0),
        "b": full(10.0),
        "z_range": full(zr0),
        "converge_thresh": full(scalar(converge_thresh)),
        "batch_id": full(batch_id, i32),
        "host_win": win,
        "host_anchor": anch,
        "n_updates": torch.zeros((n_det,), dtype=f32, device=dev),
        "obs_uv": torch.zeros((n_det, N_OBS_RING, 2), dtype=f32, device=dev),
        "obs_T": torch.zeros((n_det, N_OBS_RING, 3, 4), dtype=f32, device=dev),
        "obs_valid": torch.zeros((n_det, N_OBS_RING), dtype=torch.bool, device=dev),
        "obs_count": torch.zeros((n_det,), dtype=i32, device=dev),
        "temp_point": torch.full((n_det,), -1, dtype=i32, device=dev),
    }
    new = dict(seeds)
    for field, values in assign.items():
        old = seeds[field]
        mask = take.reshape(take.shape + (1,) * (values.ndim - 1))
        out = old.clone()
        out[slot] = torch.where(mask, values, old[slot])
        new[field] = out
    return new


def update_seeds(seeds, host_T_w, host_exposure, cur_pyr, cur_sobel_x, cur_sobel_y, T_cur_w,
                 cur_exposure, px_error_angle, cam, update_mask=None, n_levels: int = 3):
    """One observation sweep: epipolar-match every visible seed in the current
    frame and fuse the depth measurement.

    ``host_T_w`` (R, 3, 4) is the ring of host keyframe poses (world→kf),
    ``host_exposure`` (R,) their exposures; ``update_mask`` (S,) bool, if
    given, restricts the sweep to a subset.  ``cur_sobel_x/y`` are accepted
    for signature parity and not read (the gradient direction is sampled from
    the packed windows).

    Returns ``(seeds', stats)`` with ``stats`` = dict(n_visible, n_updated,
    px_match (S, 2) level-0, matched (S,))."""
    dev = seeds["valid"].device
    f32 = torch.float32
    T_cur_w = torch.as_tensor(T_cur_w, device=dev).to(f32)
    cur_exposure = torch.as_tensor(cur_exposure, dtype=f32, device=dev).reshape(())
    px_error_angle = torch.as_tensor(px_error_angle, dtype=f32, device=dev).reshape(())
    host = seeds["host"].to(torch.int64)
    T_h = host_T_w[host]
    T_cur_ref = se3.mul(T_cur_w.expand(T_h.shape), se3.inv(T_h))

    mu = seeds["mu"]
    sigma = torch.sqrt(torch.clamp_min(seeds["sigma2"], 0.0))
    mu_safe = torch.clamp_min(mu, 1e-10)
    p_cur = se3.apply(T_cur_ref, seeds["f"] / mu_safe[:, None])
    px_cur0 = cam.world2cam(p_cur)
    visible = seeds["valid"] & (p_cur[:, 2] > 0.0) & cam.is_in_frame(px_cur0, border=8)
    if update_mask is not None:
        visible = visible & update_mask

    z_inv_min = mu + 2.0 * sigma               # max inverse depth (close)
    z_inv_max = torch.clamp_min(mu - 2.0 * sigma, 1e-8)
    d_close = 1.0 / torch.clamp_min(z_inv_min, 1e-10)
    d_prior = 1.0 / mu_safe
    d_far = 1.0 / z_inv_max

    # ---- epipolar endpoints (level-0 pixel coords) ----
    p_close = se3.apply(T_cur_ref, seeds["f"] * d_close[:, None])
    p_far = se3.apply(T_cur_ref, seeds["f"] * d_far[:, None])
    geom_ok = (p_far[:, 2] > 1e-3) & (d_far > d_close * 0.999)
    px_close0 = cam.world2cam(p_close)
    px_far0 = cam.world2cam(p_far)
    epl0_len = torch.linalg.norm(px_close0 - px_far0, dim=-1)

    # ---- affine warp of the memoized host patch ----
    A_cur_ref, _ = warp_matrices(cam, cam, seeds["px"], seeds["f"], d_prior, T_cur_ref,
                                 seeds["level"])
    search_level = torch.clamp(best_search_level(A_cur_ref, n_levels - 1), 0, n_levels - 1)
    # a ±2σ segment longer than the search window holds at the warp-chosen
    # level is matched one or two levels coarser instead of cropped away:
    # full range coverage up to MAX_EPL·2^(n_levels-1) px in level-0
    # coordinates (uncertain seeds trade match precision for range; the
    # alignment below restores sub-pixel accuracy)
    for _ in range(n_levels - 1):
        fits = epl0_len * (2.0 ** -search_level.to(f32)) <= MAX_EPL
        search_level = torch.where(fits, search_level, search_level + 1)
    search_level = torch.clamp(search_level, 0, n_levels - 1)

    A_ref_cur = inv2x2(A_cur_ref)
    A_ref_cur = torch.where(torch.isfinite(A_ref_cur), A_ref_cur, torch.zeros_like(A_ref_cur))
    ref_border = warp_from_stored_windows(
        seeds["host_win"], seeds["host_anchor"], seeds["px"], seeds["level"],
        A_ref_cur, search_level)
    exposure_ratio = cur_exposure / torch.clamp_min(host_exposure[host], 1e-6)
    ref_border = ref_border * exposure_ratio[:, None, None]
    ref_patch = ref_border[:, 1:9, 1:9]

    # ---- epipolar endpoints at the search level ----
    level_scale = 2.0 ** search_level.to(f32)
    px_close_l = px_close0 / level_scale[:, None]
    px_far_l = px_far0 / level_scale[:, None]
    epl = px_close_l - px_far_l
    epl_len = torch.linalg.norm(epl, dim=-1)
    geom_ok = geom_ok & torch.isfinite(epl_len) & (epl_len > 1e-6)

    # edgelet/gradient direction gate: the segment must not run along the edge
    grad_cur = torch.sum(A_cur_ref * seeds["grad"][:, None, :], dim=-1)
    grad_cur = grad_cur / torch.clamp_min(
        torch.linalg.norm(grad_cur, dim=-1, keepdim=True), 1e-9)
    cosangle = torch.abs(torch.sum(grad_cur * epl, dim=-1) / torch.clamp_min(epl_len, 1e-9))
    dir_gate = torch.where(seeds["species"] != 0, cosangle >= 0.4,
                           torch.ones_like(geom_ok))

    active = visible & geom_ok & dir_gate

    # ---- level-packed epipolar search + refinement (one pass, all levels) ----
    mid = 0.5 * (px_far_l + px_close_l)
    windows, anchors, img_hw = pack_level_windows(
        cur_pyr, search_level, mid[:, 0], mid[:, 1], EW, n_levels)
    sr = epipolar_zmncc_search(windows, anchors, img_hw, ref_patch, px_far_l, px_close_l,
                               active)
    # loose pre-refinement gate: the dense score map is sampled at integer
    # patch positions, so a sub-pixel peak (esp. at coarse search levels)
    # reads well below its refined value; the strict NCC 0.8 gate applies
    # AFTER refinement below
    good = active & sr["ok"] & (sr["score_best"] > 0.5)

    # sub-pixel refinement straight from the integer ZMNCC peak — 2-D for
    # corners, along-normal 1-D for edgelets, one fused LM loop — with the NCC
    # and the gradient direction at the result
    is_corner = seeds["species"] == 0
    out8 = align_match(~is_corner, grad_cur, ref_border, sr["px_best"], good, windows,
                       anchors[0], anchors[1], img_hw[0], img_hw[1],
                       win=int(windows.shape[-1]), n_iter=10)
    px_ref_l = torch.stack([out8[ROW_U], out8[ROW_V]], dim=-1)
    refined_ok = out8[ROW_CONV] > 0.5
    score = out8[ROW_NCC]
    meas_ok = good & refined_ok & (score > 0.8)
    gn = torch.stack([out8[ROW_GX], out8[ROW_GY]], dim=-1)
    gn = gn / torch.clamp_min(torch.linalg.norm(gn, dim=-1, keepdim=True), 1e-9)
    normal_ok = torch.where(seeds["species"] == EDGELET,
                            torch.sum(grad_cur * gn, dim=-1) > 0.7,
                            torch.ones_like(meas_ok))
    meas_ok = meas_ok & normal_ok

    px_match0 = px_ref_l * level_scale[:, None]
    f_cur = cam.cam2world(px_match0)
    z_meas, tri_ok = triangulate_depth(T_cur_ref, seeds["f"], f_cur)
    meas_ok = meas_ok & tri_ok & (z_meas > 1e-6)
    z_meas = torch.where(meas_ok, z_meas, torch.zeros_like(z_meas))

    # ---- fusion: triangulation uncertainty of a one-pixel bearing error,
    # then the inverse-variance update ----
    T_ref_cur = se3.inv(T_cur_ref)
    t = T_ref_cur[..., :3, 3]
    fz = seeds["f"] * z_meas[:, None]
    a_vec = fz - t
    t_norm = torch.clamp_min(torch.linalg.norm(t, dim=-1), 1e-12)
    a_norm = torch.clamp_min(torch.linalg.norm(a_vec, dim=-1), 1e-12)
    alpha = torch.acos(torch.clamp(torch.sum(seeds["f"] * t, -1) / t_norm, -1.0, 1.0))
    beta = torch.acos(torch.clamp(torch.sum(a_vec * -t, -1) / (t_norm * a_norm), -1.0, 1.0))
    beta_plus = beta + px_error_angle
    gamma_plus = math.pi - alpha - beta_plus
    z_plus = t_norm * torch.sin(beta_plus) / torch.clamp_min(torch.sin(gamma_plus), 1e-9)
    tau = z_plus - z_meas
    z_safe = torch.clamp_min(z_meas, 1e-9)
    tau_inv = 0.5 * (1.0 / torch.clamp_min(z_safe - tau, 1e-7) - 1.0 / (z_safe + tau))
    tau2 = tau_inv * tau_inv

    x = 1.0 / z_safe
    id_var = seeds["sigma2"] * 1.01
    wf = tau2 / torch.clamp_min(tau2 + id_var, 1e-20)
    new_mu = (1.0 - wf) * x + wf * seeds["mu"]
    new_var = id_var * wf

    upd = meas_ok & torch.isfinite(new_mu) & torch.isfinite(new_var) & (tau2 > 0)
    out = dict(seeds)
    out["mu"] = torch.where(
        upd, torch.where(torch.abs(new_mu) < 1e-10, torch.full_like(new_mu, 1e-10), new_mu),
        seeds["mu"])
    out["sigma2"] = torch.where(upd & (new_var < seeds["sigma2"]), new_var, seeds["sigma2"])
    out["b"] = torch.where(visible & ~meas_ok, seeds["b"] + 1.0, seeds["b"])
    out["n_updates"] = seeds["n_updates"] + upd.to(f32)

    # record the observation (unit-plane measurement + frame pose) in the
    # per-seed ring for activation refinement: an indexed write at (row, ring
    # slot); every row appears once, so the write is deterministic
    s_max = seeds["valid"].shape[0]
    rows = torch.arange(s_max, device=dev)
    slot = torch.remainder(seeds["obs_count"], N_OBS_RING).to(torch.int64)
    uv_meas = f_cur[:, :2] / torch.clamp_min(f_cur[:, 2:3], 1e-9)
    obs_uv = seeds["obs_uv"].clone()
    obs_uv[rows, slot] = torch.where(upd[:, None], uv_meas, seeds["obs_uv"][rows, slot])
    obs_T = seeds["obs_T"].clone()
    obs_T[rows, slot] = torch.where(upd[:, None, None], T_cur_w[None], seeds["obs_T"][rows, slot])
    obs_valid = seeds["obs_valid"].clone()
    obs_valid[rows, slot] = seeds["obs_valid"][rows, slot] | upd
    out["obs_uv"], out["obs_T"], out["obs_valid"] = obs_uv, obs_T, obs_valid
    out["obs_count"] = seeds["obs_count"] + upd.to(torch.int32)

    return out, {
        "n_visible": torch.sum(visible.to(torch.int32)),
        "n_updated": torch.sum(upd.to(torch.int32)),
        "px_match": px_match0,
        "matched": upd,
    }


def _activation_refine(seeds, host_T_w, n_iter: int = 8, min_obs=3.0, focal=450.0):
    """Multi-view inverse-distance refinement over the per-seed observation
    ring: Gauss-Newton on the 1-DoF inverse distance, gated by a mean-shift
    test.

    The ring holds independently *matched* positions (epipolar search +
    alignment, recorded at measurement time); the verification statistic is
    the mean pixel distance between each stored match and the converged
    estimate's prediction in that view.

    Returns (mu_refined, refine_ok, dist_px) — dist_px is the mean
    verification displacement (inf when the ring is empty)."""
    f32 = torch.float32
    T_h = host_T_w[seeds["host"].to(torch.int64)]                   # (S,3,4)
    T_th = se3.mul(seeds["obs_T"], se3.inv(T_h)[:, None])           # (S,R,3,4)
    fH = seeds["f"]
    m = seeds["obs_valid"]
    w = m.to(f32)
    n_obs = torch.sum(m.to(torch.int32), dim=-1)
    t_th = T_th[..., :3, 3]
    Rf = torch.sum(T_th[..., :3, :3] * fH[:, None, None, :], dim=-1)   # (S,R,3)

    def guard(x):
        return torch.where(torch.abs(x) < 1e-9, torch.full_like(x, 1e-9), x)

    def residuals(rho):
        q = fH / torch.clamp_min(rho, 1e-10)[:, None]
        pT = se3.apply(T_th, q[:, None, :])                         # (S,R,3)
        z = guard(pT[..., 2])
        proj = pT[..., :2] / z[..., None]
        r = seeds["obs_uv"] - proj                                  # (S,R,2)
        # ∂(obs − proj)/∂rho in closed form
        den = guard(Rf[..., 2] + rho[:, None] * t_th[..., 2])
        J0 = -(t_th[..., 0] - proj[..., 0] * t_th[..., 2]) / den
        J1 = -(t_th[..., 1] - proj[..., 1] * t_th[..., 2]) / den
        return r, torch.stack([J0, J1], dim=-1)

    rho0 = seeds["mu"]

    # mean-shift verification at the converged (filtered) estimate: how far
    # do the stored matches sit from where the converged depth projects them
    r0, _ = residuals(rho0)
    d_px = focal * torch.linalg.norm(r0, dim=-1)                    # (S,R)
    dist_px = torch.sum(w * d_px, dim=-1) / torch.clamp_min(n_obs.to(f32), 1.0)
    dist_px = torch.where(n_obs > 0, dist_px, torch.full_like(dist_px, float("inf")))

    rho = rho0
    for _ in range(n_iter):
        r, Jr = residuals(rho)
        H = torch.sum(w * torch.sum(Jr * Jr, -1), dim=-1) + 1e-12
        g = -torch.sum(w * torch.sum(Jr * r, -1), dim=-1)
        rho_new = rho + g / H
        ok = torch.isfinite(rho_new) & (rho_new > 1e-10)
        rho = torch.where(ok, rho_new, rho)
    # acceptance gate: enough views, and the refinement stayed within the
    # filter's ±3σ belief
    sigma = torch.sqrt(torch.clamp_min(seeds["sigma2"], 0.0))
    ok = ((n_obs.to(f32) >= min_obs)
          & (torch.abs(rho - rho0) < 3.0 * sigma + 1e-6)
          & (rho > 1e-10))
    return torch.where(ok, rho, rho0), ok, dist_px


def harvest_and_prune(seeds, batch_counter, host_T_w=None, max_batches: int = 3,
                      min_activation_obs=3.0, focal=450.0):
    """Extract converged seeds (with multi-view activation re-verification +
    refinement when ``host_T_w`` is given) and kill stale ones.

    Converged seeds whose stored matches disagree with the converged depth
    (mean displacement > 3.2 px corners / 2.5 px edgelets) are REJECTED —
    erased without becoming landmarks; moderate disagreement (> 2.5 / 2.0
    px) keeps the filtered estimate instead of the multi-view refinement.

    Returns (seeds', bundle) where ``bundle`` is a single (S, 15) float32
    tensor packing [converged, stale, host, px(2), f(3), level, species,
    grad(2), mu, temp_point, n_updates]: one device→host copy covers
    everything the host-side harvest needs; rejected seeds are folded into
    stale so their TEMPORARY points die."""
    f32 = torch.float32
    sigma = torch.sqrt(torch.clamp_min(seeds["sigma2"], 0.0))
    converged = seeds["valid"] & (
        sigma < seeds["z_range"] / torch.clamp_min(seeds["converge_thresh"], 1e-6))
    mu = seeds["mu"]
    rejected = torch.zeros_like(converged)
    if host_T_w is not None:
        mu_ref, ref_ok, dist_px = _activation_refine(
            seeds, host_T_w, min_obs=min_activation_obs, focal=focal)
        is_edge = seeds["species"] == EDGELET
        kill_th = torch.where(is_edge, 2.5, 3.2)
        refine_th = torch.where(is_edge, 2.0, 2.5)
        has_ring = torch.isfinite(dist_px)
        rejected = converged & has_ring & (dist_px > kill_th)
        converged = converged & ~rejected
        use_ref = ref_ok & (dist_px <= refine_th)
        mu = torch.where(converged & use_ref, mu_ref, mu)
    mu_ok = (mu > 1e-10) & ((seeds["f"][:, 2] / torch.clamp_min(mu, 1e-10)) > 1e-10)
    converged = converged & mu_ok
    stale = seeds["valid"] & (((batch_counter - seeds["batch_id"]) > max_batches) | rejected)
    out = dict(seeds)
    out["valid"] = seeds["valid"] & ~converged & ~stale
    bundle = torch.cat([
        converged[:, None].to(f32),             # 0
        stale[:, None].to(f32),                 # 1
        seeds["host"][:, None].to(f32),         # 2
        seeds["px"],                            # 3, 4
        seeds["f"],                             # 5, 6, 7
        seeds["level"][:, None].to(f32),        # 8
        seeds["species"][:, None].to(f32),      # 9
        seeds["grad"],                          # 10, 11
        mu[:, None].to(f32),                    # 12
        seeds["temp_point"][:, None].to(f32),   # 13
        seeds["n_updates"][:, None].to(f32),    # 14
    ], dim=-1)
    return out, bundle


def gather_seed_windows(host_win, host_anchor, idx):
    """Row gather so the host fetches only the converged seeds' appearance
    windows (a keyframe converges tens of the table's rows).  Windows and
    anchors are flattened into ONE (n, W·W+2) buffer: one copy, not two."""
    idx = idx.to(torch.int64)
    n = idx.shape[0]
    return torch.cat([host_win[idx].reshape(n, -1), host_anchor[idx].to(torch.float32)],
                     dim=-1)

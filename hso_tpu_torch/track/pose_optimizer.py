"""Motion-only pose refinement on reprojection errors.

Levenberg-Marquardt on the unit-plane reprojection error of all matched
features, with
  * world points supplied by the caller (host-anchored upstream),
  * separate MAD scales for corners vs edgelets with fallbacks (0.5×/2×
    when one class is empty),
  * Huber weights (k=1.345), ×0.5 down-weight for TEMPORARY points,
  * per-level measurement scaling 1/2^level,
  * LM with trial loop (mu·diag damping, nu doubling, ≤5 trials/iteration):
    :func:`hso_tpu_torch.track.pose_cuda.pose_lm`, one fused kernel on the
    card,
  * post-solve outlier stripping: corners at ``reproj_thresh/focal`` (or
    χ²(5.991) when < 80 features), edgelets at 1.3 px/focal.
"""

from __future__ import annotations

import math

import torch

from hso_tpu_torch.math.robust import mad_scale_of_abs, masked_median
from hso_tpu_torch.track.pose_cuda import pose_lm, project2d, residuals


def optimize_pose(T_f_w, p_world, f_obs, level, grad, is_edgelet, is_temporary, valid,
                  focal: float = 450.0, reproj_thresh: float = 2.0, n_iter: int = 12):
    """T_f_w (3,4) world→frame estimate; p_world (N,3); f_obs (N,3) observed
    bearings; level (N,) int; grad (N,2) edgelet normals; is_edgelet /
    is_temporary / valid (N,) bool.

    Returns dict(T_f_w, inlier, n_inliers, err_init_px, err_final_px,
    scale_px, cov, error_weight)."""
    T = T_f_w.to(torch.float32)
    sqrt_inv_cov = 1.0 / torch.bitwise_left_shift(torch.ones_like(level), level).to(torch.float32)
    obs_uv = project2d(f_obs)
    inf = torch.full_like(sqrt_inv_cov, float("inf"))

    # ---- robust scales ----
    _, _, _, r_abs0 = residuals(T, p_world, obs_uv, grad, sqrt_inv_cov, is_edgelet)
    m_corner = valid & ~is_edgelet
    m_edge = valid & is_edgelet
    n_c = torch.sum(m_corner.to(torch.int32))
    n_e = torch.sum(m_edge.to(torch.int32))
    s_c = mad_scale_of_abs(torch.where(m_corner, r_abs0, inf), m_corner)
    s_e = mad_scale_of_abs(torch.where(m_edge, r_abs0, inf), m_edge)
    scale_pt = torch.clamp_min(torch.where(n_c > 0, s_c, 2.0 * s_e), 1e-7)
    scale_ls = torch.clamp_min(torch.where(n_e > 0, s_e, 0.5 * s_c), 1e-7)

    T, A_last, _, _ = pose_lm(T, p_world, obs_uv, grad, sqrt_inv_cov, is_edgelet,
                              is_temporary, valid, scale_pt, scale_ls, n_iter=n_iter)

    # ---- outlier stripping + stats ----
    _, _, r_edge_f, r_abs_f = residuals(T, p_world, obs_uv, grad, sqrt_inv_cov, is_edgelet)
    n_obs = torch.sum(valid.to(torch.int32))
    thresh_pt = torch.where(n_obs < 80,
                            torch.full_like(scale_pt, math.sqrt(5.991) / focal),
                            torch.full_like(scale_pt, reproj_thresh / focal))
    thresh_ls = 1.3 / focal
    inlier = valid & torch.where(is_edgelet, torch.abs(r_edge_f) <= thresh_ls,
                                 r_abs_f <= thresh_pt)

    def med_px(r2, m):
        return torch.sqrt(masked_median(r2, m)) * focal

    err_init = med_px(r_abs0 * r_abs0, valid)
    err_final = med_px(r_abs_f * r_abs_f, valid)
    eye6 = torch.eye(6, dtype=torch.float32, device=T.device)
    cov = torch.linalg.inv_ex(A_last * focal * focal + eye6 * 1e-12).inverse   # no error sync
    error_weight = torch.where(err_final < 1.5, torch.ones_like(err_final),
                               1.5 / torch.clamp_min(err_final, 1.5))
    return {
        "T_f_w": T,
        "inlier": inlier,
        "n_inliers": torch.sum(inlier.to(torch.int32)),
        "err_init_px": err_init,
        "err_final_px": err_final,
        "scale_px": scale_pt * focal,
        "cov": cov,
        "error_weight": error_weight,
    }

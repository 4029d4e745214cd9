"""Sliding-window bundle adjustment: Schur-complement Levenberg-Marquardt on a
dense (P, K) observation grid (torch).

The counterpart of the JAX package's ``hso_tpu.ba.local_ba``, with the same
model, layout and conventions:

  * landmarks are 1-DoF inverse distances anchored at a host feature;
    residuals are unit-plane reprojections in the target keyframe, scalar
    along the normal for edgelets, with information 1/4^level;
  * keyframes marked not free are held fixed (gauge);
  * Huber deltas per class from the median of the initial residuals
    (×1.4826; 1/f and 0.5/f when a class is empty);
  * the landmark block is scalar per point and eliminated analytically, so
    the reduced camera system is one (6K, P)·(P, 6K) product;
  * after the solve, observations are re-tested and stripped at ``strip_px``
    (corners) / 0.6·``strip_px`` (edgelets).

Observations sit at their (point slot, keyframe slot) cell with a validity
mask.  Contributions are grouped by host keyframe with a one-hot matmul, an
order-fixed sum (a float ``index_add_`` on the card is atomic and its order
would change the bits from run to run).  The LM loop has a fixed trip count
and accepts or rejects a step on the device, so it needs no host sync.

Jacobians use the tangent [rho, phi] and the update T ← exp(δ)·T.

Observation dict (leading dims (P, K) unless noted):
  ``meas`` (P,K,2) unit-plane measurement in the target frame
  ``grad`` (P,K,2) edgelet normal (unit, target frame)
  ``is_edgelet`` (P,K) bool     ``level`` (P,K) int
  ``valid`` (P,K) bool — False for the host column and empty cells
  ``f_host`` (P,3) host-frame unit bearing    ``host`` (P,) int keyframe slot
"""

from __future__ import annotations

import torch

from hso_tpu_torch.math import se3
from hso_tpu_torch.math.robust import MAD_NORMALIZER, masked_median_bisect

OBS_KEYS = ("meas", "grad", "is_edgelet", "level", "valid", "f_host", "host")


def host_onehot(host, n_kf: int):
    """(P, K) float one-hot of each point's host keyframe slot."""
    ar = torch.arange(n_kf, device=host.device)
    return (host.to(torch.int64)[:, None] == ar[None, :]).to(torch.float32)


def residuals_and_jacobians(T_kf, idist, obs):
    """Per-cell residuals and analytic Jacobians on the dense (P, K) grid.

    T_kf (K, 3, 4) world→kf poses, idist (P,) inverse distances.  Returns
    r (P,K,2) (edgelets: residual in [..., 0], [..., 1] = 0), J_rho (P,K,2),
    J_host (P,K,2,6), J_target (P,K,2,6), sqrt_info (P,K); edgelet rows are
    projected onto the normal.  The unit-plane projection Jacobian
    A = (1/z)·[[1,0,-u],[0,1,-v]] is folded in: -A·M has rows
    -(M₀ - u·M₂)/z and -(M₁ - v·M₂)/z."""
    fH = obs["f_host"]                                       # (P,3)
    rho = idist
    rho_safe = torch.where(torch.abs(rho) < 1e-10, torch.full_like(rho, 1e-10), rho)

    # relative poses T_th = T_t · T_h⁻¹ of every (host, target) pair, then
    # each point's host row (a gather: the one-hot selects exactly one row)
    K = T_kf.shape[0]
    T_inv = se3.inv(T_kf)
    T_pairs = se3.mul(T_kf[None, :], T_inv[:, None].expand(K, K, 3, 4))   # [h, t]
    T_th = T_pairs[obs["host"].to(torch.int64)]              # (P,K,3,4)

    q = fH / rho_safe[:, None]                               # (P,3) host point
    R_th = T_th[..., :3, :3]
    t_th = T_th[..., :3, 3]
    pT = torch.sum(R_th * q[:, None, None, :], -1) + t_th    # (P,K,3)
    px_, py_, pz_ = pT[..., 0], pT[..., 1], pT[..., 2]
    z = torch.where(torch.abs(pz_) < 1e-12, torch.full_like(pz_, 1e-12), pz_)
    zi = 1.0 / z
    u = px_ * zi
    v = py_ * zi
    proj = torch.stack([u, v], dim=-1)

    def neg_A_dot(m0, m1, m2):
        """rows of -A·M from M's three rows (each (..., C))."""
        return torch.stack(
            [-(m0 - u[..., None] * m2) * zi[..., None],
             -(m1 - v[..., None] * m2) * zi[..., None]], dim=-2)

    # d pT / d rho = R_th · (-q / rho)
    dpT_drho = torch.sum(R_th * (-q / rho_safe[:, None])[:, None, None, :], -1)
    J_rho2 = torch.stack(
        [-(dpT_drho[..., 0] - u * dpT_drho[..., 2]) * zi,
         -(dpT_drho[..., 1] - v * dpT_drho[..., 2]) * zi], dim=-1)    # (P,K,2)

    # d pT / d delta_target = [I | -pT^]; rows written out
    one = torch.ones_like(px_)
    zero = torch.zeros_like(px_)
    tr0 = torch.stack([one, zero, zero, zero, pz_, -py_], dim=-1)
    tr1 = torch.stack([zero, one, zero, -pz_, zero, px_], dim=-1)
    tr2 = torch.stack([zero, zero, one, py_, -px_, zero], dim=-1)
    J_t2 = neg_A_dot(tr0, tr1, tr2)                          # (P,K,2,6)

    # d pT / d delta_host = -R_th·[I | -q^]; B = R_th·[I | -q^]
    qx, qy, qz = q[..., 0], q[..., 1], q[..., 2]
    zq = torch.zeros_like(qx)
    nhq = torch.stack(                                       # -hat(q): (P,3,3)
        [torch.stack([zq, qz, -qy], -1),
         torch.stack([-qz, zq, qx], -1),
         torch.stack([qy, -qx, zq], -1)], dim=-2)
    RB = torch.sum(R_th[..., :, :, None] * nhq[:, None, None, :, :], dim=-2)
    B = torch.cat([R_th, RB], dim=-1)                        # (P,K,3,6)
    J_h2 = neg_A_dot(-B[..., 0, :], -B[..., 1, :], -B[..., 2, :])

    r2 = obs["meas"] - proj                                  # (P,K,2)

    # edgelets: project residual and Jacobians onto the normal, scalar row 0
    g = obs["grad"]
    is_e = obs["is_edgelet"][..., None]
    r_e = torch.sum(g * r2, dim=-1, keepdim=True)
    r = torch.where(is_e, torch.cat([r_e, torch.zeros_like(r_e)], -1), r2)
    Je_rho = torch.sum(g * J_rho2, dim=-1, keepdim=True)
    J_rho = torch.where(is_e, torch.cat([Je_rho, torch.zeros_like(Je_rho)], -1), J_rho2)
    Je_h = torch.sum(g[..., None] * J_h2, dim=-2)[..., None, :]
    J_h = torch.where(is_e[..., None], torch.cat([Je_h, torch.zeros_like(Je_h)], -2), J_h2)
    Je_t = torch.sum(g[..., None] * J_t2, dim=-2)[..., None, :]
    J_t = torch.where(is_e[..., None], torch.cat([Je_t, torch.zeros_like(Je_t)], -2), J_t2)

    sqrt_info = 1.0 / torch.bitwise_left_shift(torch.ones_like(obs["level"]),
                                               obs["level"]).to(torch.float32)
    return r, J_rho, J_h, J_t, sqrt_info


def residual_norms(r, obs, sqrt_info):
    """Information-scaled residual norms (P,K): |r|·s for corners, |r₀|·s
    for edgelets (their residual is already scalar in channel 0)."""
    return torch.where(obs["is_edgelet"], torch.abs(r[..., 0]),
                       torch.sqrt(torch.sum(r * r, dim=-1))) * sqrt_info


def huber_chi2(rn, is_edgelet, valid, delta_corner, delta_edge):
    delta = torch.where(is_edgelet, delta_edge, delta_corner)
    chi = torch.where(rn <= delta, rn * rn, 2.0 * delta * rn - delta * delta)
    return torch.sum(torch.where(valid, chi, torch.zeros_like(chi)))


def compute_deltas(T_kf, idist, obs, focal: float):
    """Huber deltas per class from the median of the initial residuals."""
    r0, _, _, _, sqrt_info = residuals_and_jacobians(T_kf, idist, obs)
    rn0 = residual_norms(r0, obs, sqrt_info).reshape(-1)
    is_e = obs["is_edgelet"].reshape(-1)
    valid = obs["valid"].reshape(-1)
    m_c = valid & ~is_e
    m_e = valid & is_e
    inf = torch.full_like(rn0, float("inf"))
    med_c = masked_median_bisect(torch.where(m_c, rn0, inf), m_c)
    med_e = masked_median_bisect(torch.where(m_e, rn0, inf), m_e)
    d_c = torch.where(torch.any(m_c), MAD_NORMALIZER * med_c, torch.full_like(med_c, 1.0 / focal))
    d_e = torch.where(torch.any(m_e), MAD_NORMALIZER * med_e, torch.full_like(med_e, 0.5 / focal))
    return torch.clamp_min(d_c, 1e-7), torch.clamp_min(d_e, 1e-7)


def build_reduced_system(T_kf, idist, obs, deltas, n_kf: int, n_pts: int):
    """One Gauss-Newton linearisation with analytic landmark elimination.

    Returns dict(H_cc (6K,6K), g_c (6K,), H_pp (P,), g_p (P,), W (P,6K),
    chi2, rn (P,K)); every output is a sum over observation cells."""
    K = n_kf
    r, J_rho, J_h, J_t, sqrt_info = residuals_and_jacobians(T_kf, idist, obs)
    rn = residual_norms(r, obs, sqrt_info)
    delta_c, delta_e = deltas
    delta = torch.where(obs["is_edgelet"], delta_e, delta_c)
    w = torch.where(rn <= delta, torch.ones_like(rn), delta / torch.clamp_min(rn, 1e-12))
    w = torch.where(obs["valid"], w, torch.zeros_like(w))
    chi2 = huber_chi2(rn, obs["is_edgelet"], obs["valid"], delta_c, delta_e)

    iw = w * sqrt_info * sqrt_info                           # (P,K)
    Mh = host_onehot(obs["host"], K)
    MhT = Mh.t()

    wr = r * iw[..., None]                                   # (P,K,2)
    Jr_w = J_rho * iw[..., None]

    # landmark blocks (scalar per point)
    H_pp = torch.sum(J_rho * Jr_w, dim=(1, 2))
    g_p = -torch.sum(Jr_w * r, dim=(1, 2))

    # point-camera coupling W[p] ∈ R^{6K}: the target part at its own column,
    # the host part at the point's host column
    Wt = torch.sum(J_t * Jr_w[..., None], dim=2)             # (P,K,6)
    Wh = torch.sum(J_h * Jr_w[..., None], dim=(1, 2))        # (P,6)
    W = (Wt + Mh[..., None] * Wh[:, None, :]).reshape(-1, 6 * K)

    # camera-camera blocks: (t,t) diagonal, (h,h) diagonal and (t,h) cross,
    # grouped by host with a (K, P)·(P, ·) one-hot matmul
    def outer66(Ja, Jb):
        return (Ja[..., 0, :, None] * Jb[..., 0, None, :]
                + Ja[..., 1, :, None] * Jb[..., 1, None, :]) * iw[..., None, None]

    P = Mh.shape[0]
    Htt = torch.sum(outer66(J_t, J_t), dim=0)                          # (K,6,6)
    Hhh_p = torch.sum(outer66(J_h, J_h), dim=1)                        # (P,6,6)
    Hhh = (MhT @ Hhh_p.reshape(P, 36)).reshape(K, 6, 6)
    Hth = (MhT @ outer66(J_t, J_h).reshape(P, K * 36)).reshape(K, K, 6, 6)   # [h, t]
    Hth = Hth.transpose(0, 1)                                          # [t, h]

    eyeK = torch.eye(K, dtype=torch.float32, device=T_kf.device)
    blocks = (Htt[:, None] * eyeK[:, :, None, None]
              + Hhh[:, None] * eyeK[:, :, None, None]
              + Hth                                          # (t,h) block
              + Hth.permute(1, 0, 3, 2))                     # (h,t) = (t,h)ᵀ
    H_cc = blocks.permute(0, 2, 1, 3).reshape(6 * K, 6 * K)

    g_t = -torch.sum(J_t * wr[..., None], dim=(0, 2))                 # (K,6)
    g_h_p = -torch.sum(J_h * wr[..., None], dim=(1, 2))               # (P,6)
    g_c = (g_t + MhT @ g_h_p).reshape(6 * K)

    return {"H_cc": H_cc, "g_c": g_c, "H_pp": H_pp, "g_p": g_p, "W": W,
            "chi2": chi2, "rn": rn}


def _schur_solve(sys, free_kf_mask, lam, n_kf: int):
    """Damped solve of the reduced camera system and back-substitution.

    Returns (delta_c (6K,), delta_p (P,)).  ``solve_ex`` reports a failed
    factorisation in a tensor instead of raising, so nothing waits on the
    host; a non-finite step is zeroed as in the JAX solver."""
    H_pp_d = sys["H_pp"] * (1.0 + lam) + 1e-12
    Hpp_inv = 1.0 / H_pp_d
    W = sys["W"]
    H_red = sys["H_cc"] - (W * Hpp_inv[:, None]).t() @ W
    g_red = sys["g_c"] - W.t() @ (Hpp_inv * sys["g_p"])

    # damping + gauge fixing: zero rows/cols of fixed cameras, unit diagonal
    diag = torch.diagonal(H_red)
    H_red = H_red + torch.diag(diag * lam)
    m = torch.repeat_interleave(free_kf_mask, 6).to(torch.float32)
    H_red = H_red * m[:, None] * m[None, :] + torch.diag(1.0 - m)
    g_red = g_red * m

    delta_c = torch.linalg.solve_ex(H_red, g_red).result
    delta_c = torch.where(torch.isfinite(delta_c), delta_c, torch.zeros_like(delta_c)) * m
    delta_p = Hpp_inv * (sys["g_p"] - W @ delta_c)
    return delta_c, delta_p


def _apply(T_kf, idist, delta_c, delta_p, point_valid, n_kf: int):
    d = delta_c.reshape(n_kf, 6)
    T_new = se3.mul(se3.exp(d), T_kf)
    idist_new = torch.where(point_valid, idist + delta_p, idist)
    return T_new, idist_new


def local_bundle_adjustment(T_kf, free_kf, idist, point_valid, obs, n_kf: int, n_pts: int,
                            n_iter: int = 10, focal: float = 450.0, strip_px: float = 2.0):
    """Run windowed BA: ``T_kf`` (K,3,4), ``free_kf`` (K,) bool (False: held
    fixed), ``idist`` (P,), ``point_valid`` (P,) bool, ``obs`` the dense
    (P, K) observation dict.  Returns dict(T_kf, idist, obs_inlier, chi2_init,
    chi2_final, deltas).

    One linearisation per LM iteration: the carried reduced system serves the
    solve, and the accept test compares it with the system built at the trial
    state (n_iter + 1 builds).  ``n_iter`` iterations always run; a rejected
    step leaves the state as it was."""
    T_kf = T_kf.to(torch.float32)
    idist = idist.to(torch.float32)

    deltas = compute_deltas(T_kf, idist, obs, focal)
    sys_c = build_reduced_system(T_kf, idist, obs, deltas, n_kf, n_pts)
    chi2_init = sys_c["chi2"]
    lam = 1e-5 * torch.clamp_min(torch.max(torch.diagonal(sys_c["H_cc"])), 1.0)
    nu = torch.full_like(lam, 2.0)

    for _ in range(n_iter):
        dc, dp = _schur_solve(sys_c, free_kf, lam, n_kf)
        T_new, id_new = _apply(T_kf, idist, dc, dp, point_valid, n_kf)
        sys_new = build_reduced_system(T_new, id_new, obs, deltas, n_kf, n_pts)
        accept = sys_new["chi2"] < sys_c["chi2"]
        T_kf = torch.where(accept, T_new, T_kf)
        idist = torch.where(accept, id_new, idist)
        sys_c = {k: torch.where(accept, sys_new[k], v) for k, v in sys_c.items()}
        lam = torch.where(accept, lam * 0.5, torch.clamp_max(lam * nu, 1e7))
        nu = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)

    # outlier stripping: the carried system's rn is at the final accepted state
    thresh = torch.where(obs["is_edgelet"],
                         torch.full_like(sys_c["rn"], 0.6 * strip_px / focal),
                         torch.full_like(sys_c["rn"], strip_px / focal))
    obs_inlier = obs["valid"] & (sys_c["rn"] <= thresh)
    return {
        "T_kf": T_kf,
        "idist": idist,
        "obs_inlier": obs_inlier,
        "chi2_init": chi2_init,
        "chi2_final": sys_c["chi2"],
        "deltas": deltas,
    }

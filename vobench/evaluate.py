"""Scale-aligned trajectory error.

Frozen from ``hso_tpu_torch/utils/evaluate.py`` (``umeyama``, ``ate``) and
``hso_tpu_torch/bench.py::scan_ate`` (camera centres of world→camera poses):
a least-squares similarity ``gt ≈ s·R·est + t`` (Umeyama 1991), then the
distance of each aligned centre from the truth.
"""

from __future__ import annotations

import numpy as np


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """(s, R (3, 3), t (3,)) with ``dst ≈ s·R·src + t``."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-300))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_xyz: np.ndarray, gt_xyz: np.ndarray, with_scale: bool = True) -> float:
    """RMSE of the aligned positions (the port's ``ate(...).rmse``)."""
    if len(est_xyz) < 3:
        raise ValueError(f"need >=3 matched poses, got {len(est_xyz)}")
    s, R, t = umeyama(est_xyz, gt_xyz, with_scale=with_scale)
    err = np.linalg.norm((s * (R @ est_xyz.T)).T + t - gt_xyz, axis=1)
    return float(np.sqrt(np.mean(err ** 2)))


def centres(T_c_w: np.ndarray) -> np.ndarray:
    """Camera centres (N, 3) of world→camera poses (N, 3, 4)."""
    R, t = T_c_w[:, :, :3], T_c_w[:, :, 3]
    return -np.einsum("nji,nj->ni", R, t)


def mean_rotation(M: np.ndarray) -> np.ndarray:
    """The rotation nearest to ``M`` (3, 3) in the Frobenius norm."""
    U, _, Vt = np.linalg.svd(M)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    return U @ D @ Vt


def align_errors(est: np.ndarray, gt: np.ndarray, fit: np.ndarray) -> dict:
    """Align ``est`` to ``gt`` (both (N, 3, 4) world→camera) over the frames
    ``fit`` (a boolean mask), then per frame: the position error (m) of the
    centre and the rotation error (deg) of the orientation, and the
    alignment's scale ``s`` (metres per unit of ``est``).  The centres are
    aligned by a similarity (Umeyama); the orientations by the rotation that
    best maps the estimated camera-to-world rotations onto the true ones, so
    that a sweep nearly along one line leaves no rotation about it free."""
    ce, cg = centres(est), centres(gt)
    s, R, t = umeyama(ce[fit], cg[fit])
    pos = np.linalg.norm((s * (R @ ce.T)).T + t - cg, axis=1)
    # R_gt^T ≈ R_a · R_est^T for every frame
    Ra = mean_rotation(np.einsum("nji,njk->ik", gt[fit, :, :3], est[fit, :, :3]))
    dR = np.einsum("nij,jk,nlk->nil", gt[:, :, :3], Ra, est[:, :, :3])
    cos = np.clip((np.trace(dR, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    return dict(pos_m=pos, rot_deg=np.degrees(np.arccos(cos)), scale=s)

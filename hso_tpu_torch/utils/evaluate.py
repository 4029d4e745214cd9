"""Trajectory evaluation: Umeyama alignment and absolute trajectory error.

The port's own copy of the JAX package's evaluation helpers (numpy only):
scale-aligned (Sim3/Umeyama) absolute trajectory error, the standard
monocular-VO metric.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform dst ≈ s·R·src + t (Umeyama 1991).

    Returns (s, R (3,3), t (3,)).  ``with_scale=False`` gives SE3 alignment.
    """
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
        var_s = (xs**2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-300))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


@dataclasses.dataclass
class ATEResult:
    rmse: float
    mean: float
    median: float
    max: float
    n_pairs: int
    scale: float

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"ATE rmse={self.rmse:.4f} mean={self.mean:.4f} "
            f"median={self.median:.4f} max={self.max:.4f} "
            f"n={self.n_pairs} scale={self.scale:.4f}"
        )


def ate(est_xyz: np.ndarray, gt_xyz: np.ndarray,
        with_scale: bool = True) -> ATEResult:
    """Absolute trajectory error after Umeyama alignment of matched points."""
    if len(est_xyz) < 3:
        raise ValueError(f"need >=3 matched poses, got {len(est_xyz)}")
    s, R, t = umeyama(est_xyz, gt_xyz, with_scale=with_scale)
    aligned = (s * (R @ est_xyz.T)).T + t
    err = np.linalg.norm(aligned - gt_xyz, axis=1)
    return ATEResult(
        rmse=float(np.sqrt(np.mean(err**2))),
        mean=float(np.mean(err)),
        median=float(np.median(err)),
        max=float(np.max(err)),
        n_pairs=len(err),
        scale=s,
    )

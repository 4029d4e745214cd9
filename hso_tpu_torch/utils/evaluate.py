"""Trajectory evaluation: TUM-format I/O, Umeyama alignment, ATE.

The port's own copy of the JAX package's evaluation helpers (numpy only):
TUM trajectory files and EuRoC csv ground truth, nearest-stamp association,
and scale-aligned (Sim3/Umeyama) absolute trajectory error, the standard
monocular-VO metric.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from hso_tpu_torch.math import se3np


def load_tum(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read a TUM trajectory file → (stamps (N,), poses (N, 7) raw rows).

    Rows are ``stamp tx ty tz qx qy qz qw``; comment lines ('#') skipped.
    """
    stamps, rows = [], []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(x) for x in line.split()]
            if len(vals) < 8:
                continue
            stamps.append(vals[0])
            rows.append(vals[1:8])
    return np.asarray(stamps, np.float64), np.asarray(rows, np.float64)


def load_any(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Ground truth as (stamps (N,), positions (N, 3)): TUM whitespace rows, or
    EuRoC comma-separated rows with nanosecond stamps."""
    with open(path) as fh:
        first = ""
        for line in fh:
            if line.strip() and not line.startswith("#"):
                first = line
                break
    if "," in first:
        rows = np.genfromtxt(path, delimiter=",", comments="#")
        return rows[:, 0] * 1e-9, rows[:, 1:4]
    stamps, rows = load_tum(path)
    return stamps, rows[:, :3]


def associate(stamps_a: np.ndarray, stamps_b: np.ndarray,
              max_dt: float = 0.02) -> tuple[np.ndarray, np.ndarray]:
    """Nearest-stamp association a→b (indices), pairs farther than ``max_dt``
    dropped, each b used once (greedy by distance)."""
    if len(stamps_a) == 0 or len(stamps_b) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    order = np.argsort(stamps_b)
    sb = stamps_b[order]
    pos = np.searchsorted(sb, stamps_a)
    pos = np.clip(pos, 1, len(sb) - 1)
    left = sb[pos - 1]
    right = sb[pos]
    take_right = np.abs(right - stamps_a) < np.abs(stamps_a - left)
    j = np.where(take_right, pos, pos - 1)
    dt = np.abs(sb[j] - stamps_a)
    keep = dt <= max_dt
    ia = np.nonzero(keep)[0]
    jb = order[j[keep]]
    seen: set[int] = set()
    sel_a, sel_b = [], []
    for k in np.argsort(dt[keep]):
        b = int(jb[k])
        if b in seen:
            continue
        seen.add(b)
        sel_a.append(int(ia[k]))
        sel_b.append(b)
    o = np.argsort(sel_a)
    return np.asarray(sel_a, np.int64)[o], np.asarray(sel_b, np.int64)[o]


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


def evaluate_tum_files(est_path: str, gt_path: str, max_dt: float = 0.02,
                       with_scale: bool = True) -> ATEResult:
    """ATE between two TUM trajectory files (nearest-stamp association)."""
    st_e, rows_e = load_tum(est_path)
    st_g, rows_g = load_tum(gt_path)
    ia, ib = associate(st_e, st_g, max_dt=max_dt)
    if len(ia) < 3:
        raise ValueError(
            f"only {len(ia)} associated pairs (est {len(st_e)}, gt {len(st_g)},"
            f" max_dt {max_dt})"
        )
    return ate(rows_e[ia, :3], rows_g[ib, :3], with_scale=with_scale)


def trajectory_xyz(traj: list[tuple[float, np.ndarray]]) -> np.ndarray:
    """Camera centres from a ``FrameHandler.trajectory`` list of (ts, T_f_w)."""
    return np.stack([se3np.translation(se3np.inv(T)) for _, T in traj])

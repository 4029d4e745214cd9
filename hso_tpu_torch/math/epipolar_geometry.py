"""Two-view relative geometry: essential-matrix RANSAC + triangulation.

The bootstrap's two-view pose: batched 5-point (or normalized 8-point)
essential-matrix hypotheses scored by Sampson distance, decomposition with
cheirality voting, and midpoint triangulation — host numpy in float64 (runs
once at start-up).  A homography model (4-point DLT RANSAC + Faugeras SVD
decomposition) is estimated alongside, and the model with the lower
triangulation reprojection error wins: essential-matrix estimation is
degenerate for planar scenes.  The same code on the same inputs gives the
same bits as the JAX package's copy (RANSAC draws from ``seed``).
"""

from __future__ import annotations

import numpy as np

from hso_tpu_torch.math import se3np


def _essential_from_8pt(uv1: np.ndarray, uv2: np.ndarray) -> np.ndarray:
    """Normalized 8-point: uv are unit-plane coords (N>=8, 2)."""
    def normalize(uv):
        m = uv.mean(axis=0)
        s = np.sqrt(2.0) / max(np.mean(np.linalg.norm(uv - m, axis=1)), 1e-12)
        T = np.array([[s, 0, -s * m[0]], [0, s, -s * m[1]], [0, 0, 1]])
        return (uv - m) * s, T

    a, Ta = normalize(uv1)
    b, Tb = normalize(uv2)
    A = np.stack(
        [
            b[:, 0] * a[:, 0], b[:, 0] * a[:, 1], b[:, 0],
            b[:, 1] * a[:, 0], b[:, 1] * a[:, 1], b[:, 1],
            a[:, 0], a[:, 1], np.ones(len(a)),
        ],
        axis=-1,
    )
    _, _, Vt = np.linalg.svd(A)
    F = Vt[-1].reshape(3, 3)
    F = Tb.T @ F @ Ta
    # project to essential manifold
    U, S, Vt = np.linalg.svd(F)
    s = (S[0] + S[1]) / 2.0
    E = U @ np.diag([s, s, 0.0]) @ Vt
    return E


# ---------------------------------------------------------------- 5-point
# Nistér/Stewénius five-point minimal solver.  The
# ten cubic constraints det(E)=0 and 2·E·EᵀE − tr(E·Eᵀ)·E = 0 are expanded
# numerically with a tiny exponent-dict polynomial arithmetic (no hand-
# derived symbolic tables to get wrong), reduced against the 10 degree-3
# monomials, and solved via the 10×10 action-matrix eigendecomposition
# (Stewénius et al., "Recent developments on direct relative orientation").

_D3 = [(3, 0, 0), (2, 1, 0), (2, 0, 1), (1, 2, 0), (1, 1, 1),
       (1, 0, 2), (0, 3, 0), (0, 2, 1), (0, 1, 2), (0, 0, 3)]
_B10 = [(2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1),
        (0, 0, 2), (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
_MONO20 = {m: i for i, m in enumerate(_D3 + _B10)}


def _pmul(a: dict, b: dict) -> dict:
    out = {}
    for ea, ca in a.items():
        for eb, cb in b.items():
            e = (ea[0] + eb[0], ea[1] + eb[1], ea[2] + eb[2])
            out[e] = out.get(e, 0.0) + ca * cb
    return out


def _padd(*polys) -> dict:
    out = {}
    for p in polys:
        for e, c in p.items():
            out[e] = out.get(e, 0.0) + c
    return out


def _pscale(a: dict, s: float) -> dict:
    return {e: c * s for e, c in a.items()}


def _essential_candidates_5pt(uv1: np.ndarray, uv2: np.ndarray):
    """Up to 10 essential matrices from 5 unit-plane correspondences."""
    x1 = np.concatenate([uv1, np.ones((len(uv1), 1))], axis=-1)
    x2 = np.concatenate([uv2, np.ones((len(uv2), 1))], axis=-1)
    # q2ᵀ E q1 = 0, E row-major: coefficient of E[i,j] is x2[i]·x1[j]
    Q = np.einsum("ni,nj->nij", x2, x1).reshape(len(uv1), 9)
    _, _, Vt = np.linalg.svd(Q)
    Eb = Vt[-4:][::-1].reshape(4, 3, 3)          # E1..E3 (x,y,z) + E4 (1)

    def entry(i, j):
        return {(1, 0, 0): Eb[0, i, j], (0, 1, 0): Eb[1, i, j],
                (0, 0, 1): Eb[2, i, j], (0, 0, 0): Eb[3, i, j]}

    E = [[entry(i, j) for j in range(3)] for i in range(3)]
    # det(E) = 0
    det = _padd(
        _pmul(E[0][0], _padd(_pmul(E[1][1], E[2][2]),
                             _pscale(_pmul(E[1][2], E[2][1]), -1.0))),
        _pmul(E[0][1], _padd(_pmul(E[1][2], E[2][0]),
                             _pscale(_pmul(E[1][0], E[2][2]), -1.0))),
        _pmul(E[0][2], _padd(_pmul(E[1][0], E[2][1]),
                             _pscale(_pmul(E[1][1], E[2][0]), -1.0))),
    )
    # EEᵀE − ½·tr(EEᵀ)·E = 0 (9 cubics)
    EEt = [[_padd(*[_pmul(E[i][k], E[j][k]) for k in range(3)])
            for j in range(3)] for i in range(3)]
    tr = _padd(EEt[0][0], EEt[1][1], EEt[2][2])
    polys = [det]
    for i in range(3):
        for j in range(3):
            lhs = _padd(*[_pmul(EEt[i][k], E[k][j]) for k in range(3)])
            polys.append(_padd(lhs, _pscale(_pmul(tr, E[i][j]), -0.5)))

    M = np.zeros((10, 20))
    for r, p in enumerate(polys):
        for e, c in p.items():
            M[r, _MONO20[e]] = c
    try:
        B = np.linalg.solve(M[:, :10], M[:, 10:])   # d3 = -B · b10
    except np.linalg.LinAlgError:
        return []
    A = np.zeros((10, 10))
    A[0] = -B[0]          # x·x²  = x³
    A[1] = -B[1]          # x·xy  = x²y
    A[2] = -B[2]          # x·xz  = x²z
    A[3] = -B[3]          # x·y²  = xy²
    A[4] = -B[4]          # x·yz  = xyz
    A[5] = -B[5]          # x·z²  = xz²
    A[6, 0] = 1.0         # x·x   = x²
    A[7, 1] = 1.0         # x·y   = xy
    A[8, 2] = 1.0         # x·z   = xz
    A[9, 6] = 1.0         # x·1   = x
    try:
        _, vecs = np.linalg.eig(A)
    except np.linalg.LinAlgError:
        return []
    out = []
    for k in range(10):
        v = vecs[:, k]
        if abs(v[9]) < 1e-12:
            continue
        v = v / v[9]
        if np.max(np.abs(v.imag)) > 1e-6:
            continue
        x, y, z = v[6].real, v[7].real, v[8].real
        Ek = x * Eb[0] + y * Eb[1] + z * Eb[2] + Eb[3]
        n = np.linalg.norm(Ek)
        if n > 1e-12:
            out.append(Ek / n)
    return out


def _sampson(E, uv1, uv2):
    x1 = np.concatenate([uv1, np.ones((len(uv1), 1))], axis=-1)
    x2 = np.concatenate([uv2, np.ones((len(uv2), 1))], axis=-1)
    Ex1 = x1 @ E.T
    Etx2 = x2 @ E
    num = np.sum(x2 * Ex1, axis=-1) ** 2
    den = Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2
    return num / np.maximum(den, 1e-18)


def triangulate_midpoint(T_21, f1, f2):
    """Depths along f1 in frame 1 for rays f1 (frame1) and f2 (frame2) under
    p2 = T_21 · p1.  Returns (p1 (N,3), depth1 (N,))."""
    R = se3np.rotation(T_21)
    t = se3np.translation(T_21)
    a0 = f1 @ R.T
    depth1 = np.zeros(len(f1))
    p1 = np.zeros_like(f1)
    A = np.stack([a0, np.asarray(f2)], axis=-1)          # (N,3,2)
    AtA = np.einsum("nij,nik->njk", A, A)
    Atb = -np.einsum("nij,ni->nj", A, np.broadcast_to(t, f1.shape))
    det = AtA[:, 0, 0] * AtA[:, 1, 1] - AtA[:, 0, 1] ** 2
    ok = np.abs(det) > 1e-12
    lam = np.zeros((len(f1), 2))
    lam[ok] = np.linalg.solve(AtA[ok], Atb[ok][..., None])[..., 0]
    depth1 = lam[:, 0]
    p1 = f1 * depth1[:, None]
    return p1, depth1


def _homography_dlt(uv1: np.ndarray, uv2: np.ndarray) -> np.ndarray:
    """Normalized DLT homography x2 ~ H x1 from >=4 unit-plane correspondences."""
    def normalize(uv):
        m = uv.mean(axis=0)
        s = np.sqrt(2.0) / max(np.mean(np.linalg.norm(uv - m, axis=1)), 1e-12)
        T = np.array([[s, 0, -s * m[0]], [0, s, -s * m[1]], [0, 0, 1]])
        return (uv - m) * s, T

    a, Ta = normalize(uv1)
    b, Tb = normalize(uv2)
    n = len(a)
    A = np.zeros((2 * n, 9))
    A[0::2, 0:2] = a
    A[0::2, 2] = 1.0
    A[0::2, 6:8] = -b[:, 0:1] * a
    A[0::2, 8] = -b[:, 0]
    A[1::2, 3:5] = a
    A[1::2, 5] = 1.0
    A[1::2, 6:8] = -b[:, 1:2] * a
    A[1::2, 8] = -b[:, 1]
    _, _, Vt = np.linalg.svd(A)
    H = Vt[-1].reshape(3, 3)
    return np.linalg.inv(Tb) @ H @ Ta


def _homography_transfer_err(H, uv1, uv2):
    x1 = np.concatenate([uv1, np.ones((len(uv1), 1))], axis=-1)
    Hx = x1 @ H.T
    w = np.where(np.abs(Hx[:, 2]) < 1e-12, 1e-12, Hx[:, 2])
    return np.sum((Hx[:, :2] / w[:, None] - uv2) ** 2, axis=-1)


def _decompose_homography(H):
    """Faugeras SVD decomposition → candidate T_21 (R, t/d) poses."""
    U, S, Vt = np.linalg.svd(H)
    d1, d2, d3 = S
    if d1 / max(d2, 1e-12) < 1.0001 or d2 / max(d3, 1e-12) < 1.0001:
        return []  # pure rotation / degenerate
    s = np.linalg.det(U) * np.linalg.det(Vt)
    x1 = np.sqrt(max((d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3), 0.0))
    x3 = np.sqrt(max((d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3), 0.0))
    sin_t = np.sqrt(max((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)) / (
        (d1 + d3) * d2
    )
    cos_t = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2)
    cands = []
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            Rp = np.array(
                [
                    [cos_t, 0, -e1 * e3 * sin_t],
                    [0, 1, 0],
                    [e1 * e3 * sin_t, 0, cos_t],
                ]
            )
            tp = (d1 - d3) * np.array([e1 * x1, 0.0, -e3 * x3])
            R = s * U @ Rp @ Vt
            t = U @ tp
            nt = np.linalg.norm(t)
            if nt > 1e-9:
                cands.append(se3np.from_Rt(R, t / nt))
    return cands


def _cheirality_pick(cands, f1, f2):
    best_T, best_votes = None, -1
    for T in cands:
        p1, z1 = triangulate_midpoint(T, f1, f2)
        p2 = se3np.apply(T, p1)
        votes = int(np.sum((z1 > 0) & (p2[:, 2] > 0)))
        if votes > best_votes:
            best_votes = votes
            best_T = T
    return best_T, best_votes


def recover_pose_homography_ransac(
    f1, f2, focal, thresh_px: float = 2.0, n_iter: int = 200, seed: int = 0
):
    uv1 = f1[:, :2] / f1[:, 2:3]
    uv2 = f2[:, :2] / f2[:, 2:3]
    n = len(uv1)
    if n < 8:
        return None
    rng = np.random.default_rng(seed)
    thresh = (thresh_px / focal) ** 2
    best_inl, best_cnt = None, -1
    for _ in range(n_iter):
        idx = rng.choice(n, 4, replace=False)
        try:
            H = _homography_dlt(uv1[idx], uv2[idx])
        except np.linalg.LinAlgError:
            continue
        d = _homography_transfer_err(H, uv1, uv2)
        inl = d < thresh
        if inl.sum() > best_cnt:
            best_cnt = int(inl.sum())
            best_inl = inl
    if best_inl is None or best_cnt < 8:
        return None
    H = _homography_dlt(uv1[best_inl], uv2[best_inl])
    d = _homography_transfer_err(H, uv1, uv2)
    inliers = d < thresh
    cands = _decompose_homography(H)
    if not cands:
        return None
    T, votes = _cheirality_pick(cands, f1[inliers], f2[inliers])
    if T is None or votes < 0.5 * inliers.sum():
        return None
    return {"T_21": T, "inliers": inliers, "n_inliers": int(inliers.sum())}


def median_reproj_error(T_21, f1, f2, focal):
    """Median two-view triangulation reprojection error in pixels."""
    p1, z1 = triangulate_midpoint(T_21, f1, f2)
    good = z1 > 1e-9
    if good.sum() < 4:
        return np.inf
    p2 = se3np.apply(T_21, p1[good])
    ok2 = p2[:, 2] > 1e-9
    if ok2.sum() < 4:
        return np.inf
    uv1 = p1[good][:, :2] / p1[good][:, 2:3]
    uv2 = p2[ok2][:, :2] / p2[ok2][:, 2:3]
    e1 = np.linalg.norm(uv1 - f1[good][:, :2] / f1[good][:, 2:3], axis=-1)
    e2 = np.linalg.norm(uv2 - (f2[good][ok2][:, :2] / f2[good][ok2][:, 2:3]), axis=-1)
    return float(np.median(np.concatenate([e1, e2])) * focal)


def recover_pose_twoview(f1, f2, focal, thresh_px: float = 2.0, seed: int = 0):
    """Model selection: estimate both essential
    and homography relative poses, keep the one with lower median
    triangulation reprojection error."""
    res_e = recover_pose_ransac(f1, f2, focal, thresh_px, seed=seed)
    res_h = recover_pose_homography_ransac(f1, f2, focal, thresh_px, seed=seed)
    best, best_err = None, np.inf
    for res in (res_e, res_h):
        if res is None:
            continue
        err = median_reproj_error(res["T_21"], f1[res["inliers"]], f2[res["inliers"]], focal)
        if err < best_err:
            best, best_err = res, err
    if best is not None:
        best = dict(best)
        best["model_err_px"] = best_err
    return best


def recover_pose_ransac(
    f1: np.ndarray, f2: np.ndarray, focal: float,
    thresh_px: float = 2.0, n_iter: int = 300, seed: int = 0,
    method: str = "5pt",
):
    """Estimate T_21 (frame1→frame2, unit translation) from bearing
    correspondences.  Returns dict(T_21, inliers, n_inliers) or None.

    ``method="5pt"`` (default) draws Nistér 5-point minimal samples — a
    minimal hypothesis survives ~(1/(1-ε))³ higher outlier rates ε than the
    8-point sample for the same iteration budget and is exact under planar
    degeneracy of the linear solver's null space.  ``method="8pt"``
    keeps the normalized-8-point generator (kept for A/B tests).  The
    consensus model is always refit with the 8-point least-squares on the
    full inlier set."""
    uv1 = f1[:, :2] / f1[:, 2:3]
    uv2 = f2[:, :2] / f2[:, 2:3]
    n = len(uv1)
    if n < 8:
        return None
    rng = np.random.default_rng(seed)
    thresh = (thresh_px / focal) ** 2
    best_inl = None
    best_cnt = -1
    for _ in range(n_iter):
        if method == "5pt":
            idx = rng.choice(n, 5, replace=False)
            cands = _essential_candidates_5pt(uv1[idx], uv2[idx])
        else:
            idx = rng.choice(n, 8, replace=False)
            try:
                cands = [_essential_from_8pt(uv1[idx], uv2[idx])]
            except np.linalg.LinAlgError:
                continue
        for E in cands:
            d = _sampson(E, uv1, uv2)
            inl = d < thresh
            if inl.sum() > best_cnt:
                best_cnt = int(inl.sum())
                best_inl = inl
    if best_inl is None or best_cnt < 8:
        return None
    # refit on inliers
    E = _essential_from_8pt(uv1[best_inl], uv2[best_inl])
    d = _sampson(E, uv1, uv2)
    inliers = d < thresh

    # decompose: 4 candidate (R, t)
    U, _, Vt = np.linalg.svd(E)
    if np.linalg.det(U) < 0:
        U = -U
    if np.linalg.det(Vt) < 0:
        Vt = -Vt
    W = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]])
    cands = []
    for R in (U @ W @ Vt, U @ W.T @ Vt):
        for t in (U[:, 2], -U[:, 2]):
            cands.append(se3np.from_Rt(R, t))
    # cheirality vote on inliers
    best_T, best_votes = None, -1
    fi1 = f1[inliers]
    fi2 = f2[inliers]
    for T in cands:
        p1, z1 = triangulate_midpoint(T, fi1, fi2)
        p2 = se3np.apply(T, p1)
        votes = int(np.sum((z1 > 0) & (p2[:, 2] > 0)))
        if votes > best_votes:
            best_votes = votes
            best_T = T
    if best_T is None or best_votes < 0.5 * inliers.sum():
        return None
    return {"T_21": best_T, "inliers": inliers, "n_inliers": int(inliers.sum())}

"""The plain reference of the windowed bundle adjustment: a solve's own problem
solved again in float64, and the program's answer judged by the cost it
reaches.

The model is the one the program documents for its solver, written out here
on its own: a landmark is an inverse distance along a unit bearing of its host
keyframe; a residual is the unit-plane reprojection into a target keyframe
(for an edgelet, its component along the edgelet's normal), scaled by
``2^-level``; the Huber threshold of each class is 1.4826 × the upper median of
the start's scaled residuals (``1/f`` and ``0.5/f`` for a class with none);
keyframes marked not free, and points marked not valid, stay where they are.
The reference minimises that cost by Levenberg–Marquardt on the Gauss–Newton
system of its Huber weights, the Jacobians by forward-mode differentiation,
each landmark eliminated through its own diagonal entry.

The number is the share of the cost's possible decrease that the program's
solve left undone, ``(C(program) − C*) / (C(start) − C*)``, with ``C*`` the
lower of the reference's minimum and the program's own cost: about 0 for a
solve that converged, 1 for one that returned its start.

This follows the program from its own state: the problem (which points, which
observations, the start) is what the handler assembled.  The start is judged
apart, by the poses and the map against the scene (``check.judge``).
"""

from __future__ import annotations

import torch

MAD_NORMALIZER = 1.4826
F64 = torch.float64


def _hat(w: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(K, 3, 4) poses of twists ``xi`` (K, 6) = (translation, rotation)."""
    v, w = xi[:, :3], xi[:, 3:]
    th = w.norm(dim=-1)[:, None, None]
    W = _hat(w)
    I = torch.eye(3, dtype=xi.dtype, device=xi.device).expand_as(W)
    small = th < 1e-8
    ths = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, torch.ones_like(th), torch.sin(ths) / ths)
    b = torch.where(small, torch.full_like(th, 0.5), (1 - torch.cos(ths)) / ths ** 2)
    c = torch.where(small, torch.full_like(th, 1 / 6), (1 - a) / ths ** 2)
    R = I + a * W + b * (W @ W)
    V = I + b * W + c * (W @ W)
    return torch.cat([R, (V @ v[..., None])], dim=-1)


def _perturbed(T: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """``(I + hat(d))·T``: the first order of ``exp(d)·T``, for the Jacobian."""
    W = _hat(d[:, 3:])
    R, t = T[..., :3], T[..., 3]
    return torch.cat([R + W @ R, (t + (W @ t[..., None])[..., 0] + d[:, :3])[..., None]], -1)


def residuals(T: torch.Tensor, idist: torch.Tensor, obs: dict) -> torch.Tensor:
    """(P, K, 2) scaled residuals (an edgelet's in channel 0, its channel 1
    zero; cells not valid zero) of world→keyframe poses ``T`` (K, 3, 4)."""
    host = obs["host"]
    R, t = T[..., :3], T[..., 3]
    rho = torch.where(idist.abs() < 1e-10, torch.full_like(idist, 1e-10), idist)
    q = obs["f_host"] / rho[:, None]                          # host-frame point
    X = torch.einsum("pji,pj->pi", R[host], q - t[host])      # world point
    pT = torch.einsum("kij,pj->pki", R, X) + t[None]          # (P, K, 3)
    z = pT[..., 2:3]
    z = torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)
    r2 = obs["meas"] - pT[..., :2] / z
    re = (obs["grad"] * r2).sum(-1)
    r = torch.where(obs["is_edgelet"][..., None], torch.stack([re, torch.zeros_like(re)], -1), r2)
    r = r * obs["scale"][..., None]
    return torch.where(obs["valid"][..., None], r, torch.zeros_like(r))


def huber_cost(rn: torch.Tensor, obs: dict, deltas) -> torch.Tensor:
    d = torch.where(obs["is_edgelet"], deltas[1], deltas[0])
    chi = torch.where(rn <= d, rn * rn, 2.0 * d * rn - d * d)
    return torch.where(obs["valid"], chi, torch.zeros_like(chi)).sum()


def start_deltas(rn0: torch.Tensor, obs: dict, focal: float):
    """The Huber thresholds (corner, edgelet) from the start's residuals."""
    out = []
    for edge, fallback in ((False, 1.0 / focal), (True, 0.5 / focal)):
        v = torch.sort(rn0[obs["valid"] & (obs["is_edgelet"] == edge)]).values
        d = MAD_NORMALIZER * float(v[len(v) // 2]) if len(v) else fallback
        out.append(max(d, 1e-7))
    return tuple(out)


def _problem(args, kw) -> tuple:
    T, free, idist, pvalid, obs = args
    dev = T.device
    o = {k: v.to(dev) for k, v in obs.items()}
    ob = dict(meas=o["meas"].to(F64), grad=o["grad"].to(F64), f_host=o["f_host"].to(F64),
              is_edgelet=o["is_edgelet"].bool(), valid=o["valid"].bool(),
              host=o["host"].to(torch.int64),
              scale=torch.pow(2.0, -o["level"].to(F64)))
    return T.to(F64), free.bool(), idist.to(F64), pvalid.bool(), ob, float(kw["focal"])


def minimise(T, free, idist, pvalid, obs, deltas, n_iter: int = 60):
    """The reference's minimum of the cost from the start ``(T, idist)``:
    (T, idist, cost)."""
    K = T.shape[0]
    cfree = free.repeat_interleave(6)
    cost = huber_cost(residuals(T, idist, obs).norm(dim=-1), obs, deltas)
    lam = 1e-4
    eye = torch.eye(6 * K, dtype=F64, device=T.device)
    for _ in range(n_iter):
        r = residuals(T, idist, obs)
        rn = r.norm(dim=-1)
        d = torch.where(obs["is_edgelet"], deltas[1], deltas[0])
        w = torch.where(rn <= d, torch.ones_like(rn), d / rn.clamp_min(1e-300))
        w = torch.where(obs["valid"], w, torch.zeros_like(w))[..., None]
        # each cell depends on its own point only: one tangent of ones gives
        # every landmark's column
        _, Jp = torch.func.jvp(lambda x: residuals(T, x, obs), (idist,), (torch.ones_like(idist),))
        zero = torch.zeros(K, 6, dtype=F64, device=T.device)

        def by_pose(dv):
            return torch.func.jvp(lambda x: residuals(_perturbed(T, x.reshape(K, 6)), idist, obs),
                                  (zero.reshape(-1),), (dv,))[1]

        Jc = torch.func.vmap(by_pose)(eye)                     # (6K, P, K, 2)
        Hpp = (w * Jp * Jp).sum((1, 2))
        gp = (w * Jp * r).sum((1, 2))
        wJc = Jc * w[None]
        Hcc = wJc.reshape(6 * K, -1) @ Jc.reshape(6 * K, -1).T
        gc = (wJc * r[None]).sum((1, 2, 3))
        Hcp = (wJc * Jp[None]).sum((2, 3))                     # (6K, P)
        live = pvalid & (Hpp > 0)
        while lam < 1e12:
            Hpp_inv = torch.where(live, 1.0 / (Hpp * (1 + lam) + 1e-300), torch.zeros_like(Hpp))
            S = Hcc + lam * torch.diag(torch.diagonal(Hcc)) - (Hcp * Hpp_inv) @ Hcp.T
            b = -gc + Hcp @ (Hpp_inv * gp)
            S = S[cfree][:, cfree]
            dc = torch.zeros(6 * K, dtype=F64, device=T.device)
            if cfree.any():
                dc[cfree] = torch.linalg.solve(S, b[cfree])
            dp = -Hpp_inv * (gp + Hcp.T @ dc)
            T_new = torch.where(free[:, None, None], se3_exp(dc.reshape(K, 6)) @ torch.cat(
                [T, torch.tensor([0.0, 0, 0, 1], dtype=F64, device=T.device).expand(K, 1, 4)],
                1), T)
            id_new = torch.where(live, idist + dp, idist)
            c_new = huber_cost(residuals(T_new, id_new, obs).norm(dim=-1), obs, deltas)
            if torch.isfinite(c_new) and c_new < cost:
                done = float(cost - c_new) <= 1e-10 * float(cost)
                T, idist, cost, lam = T_new, id_new, c_new, max(lam * 0.3, 1e-12)
                break
            lam *= 10.0
        else:
            break
        if done:
            break
    return T, idist, float(cost)


def solve_gap(args, kw, out) -> dict:
    """The judged solve's readings: the start's, the program's and the
    reference's cost, and the share of the decrease left undone (``gap``,
    None where the start leaves nothing to decrease)."""
    T0, free, id0, pvalid, obs, focal = _problem(args, kw)
    rn0 = residuals(T0, id0, obs).norm(dim=-1)
    deltas = start_deltas(rn0, obs, focal)
    c0 = float(huber_cost(rn0, obs, deltas))
    Tp, idp = out["T_kf"].to(F64), out["idist"].to(F64)
    cp = float(huber_cost(residuals(Tp, idp, obs).norm(dim=-1), obs, deltas))
    _, _, cref = minimise(T0, free, id0, pvalid, obs, deltas)
    best = min(cref, cp)
    gap = (cp - best) / (c0 - best) if c0 - best > 1e-9 * c0 else None
    return dict(cost_start=c0, cost_program=cp, cost_reference=cref, gap=gap,
                n_obs=int(obs["valid"].sum()), n_iter=int(kw["n_iter"]))

"""Multi-rank sliding-window BA: the point-sharded Schur reduction over
``torch.distributed``.

The counterpart of the JAX package's ``hso_tpu.ba.distributed`` (a
``shard_map`` over a device mesh with ``psum``).  Here each rank is one
process holding a contiguous block of point rows of the dense (P, K)
observation grid:

  * sharding is pure padding: point slot s belongs to rank ``s // p_local``
    and every observation cell rides its point's row, so nothing moves and
    nothing is dropped (:func:`shard_problem`);
  * each rank linearises its own block (:func:`hso_tpu_torch.ba.local_ba.
    build_reduced_system` is a sum over cells), so the landmark blocks
    ``H_pp``/``g_p`` and the coupling ``W`` stay local;
  * only the reduced camera system is global: ``H_cc``, ``g_c`` and chi2 of
    each linearisation, and in the Schur step ``Wᵀ·H_pp⁻¹·W`` and
    ``Wᵀ·H_pp⁻¹·g_p``, are summed over the ranks with ``all_reduce`` (each
    group of them packed into one tensor, one collective);
  * the damped 6K solve runs replicated on every rank, the landmark
    back-substitution stays local.

No float atomics: the ranks' partial sums are reduced by the backend's
collective, which for a fixed world size and tensor size adds them in a
fixed order, so a run repeats bit for bit.  Robust deltas are computed on the
whole problem and passed in, since medians do not distribute as sums.

Without an initialised process group the solver runs over a world of one
rank: one block, the sum over it, no collective; it never initialises a
group itself.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from hso_tpu_torch.ba.local_ba import (
    OBS_KEYS,
    _apply,
    build_reduced_system,
    compute_deltas,
    huber_chi2,
    residual_norms,
    residuals_and_jacobians,
)


def _world(group=None) -> tuple[int, int]:
    """(rank, world size) in ``group``; (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(group), dist.get_world_size(group)
    return 0, 1


def _reduce(parts: list, group) -> list:
    """The sum of each tensor over the ranks, through one ``all_reduce`` of
    their concatenation; the tensors themselves with a world of one."""
    if _world(group)[1] == 1:
        return parts
    flat = torch.cat([p.reshape(-1) for p in parts])
    dist.all_reduce(flat, group=group)
    out, off = [], 0
    for p in parts:
        out.append(flat[off:off + p.numel()].reshape(p.shape))
        off += p.numel()
    return out


def _gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` (all of one shape), concatenated in rank order."""
    world = _world(group)[1]
    if world == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def make_distributed_ba(n_kf: int, n_pts_local: int, n_iter: int = 10, group=None):
    """The point-sharded LM solve for a fixed shape.

    The returned function takes (T_kf (K,3,4) replicated, free_kf (K,)
    replicated, idist (P_l,) this rank's block, point_valid (P_l,), obs dict of
    this rank's rows, delta_corner, delta_edge) and returns (T_kf', idist'
    (this rank's block), chi2_final, rn (P_l, K) this rank's final residual
    norms).  Every rank of ``group`` calls it together."""
    K = n_kf

    def build(T_c, id_c, obs, deltas):
        sys = build_reduced_system(T_c, id_c, obs, deltas, K, n_pts_local)
        # only the camera system and the energy are global; H_pp, g_p, W and
        # rn stay local to this block
        sys["H_cc"], sys["g_c"], sys["chi2"] = _reduce(
            [sys["H_cc"], sys["g_c"], sys["chi2"]], group)
        return sys

    def schur_solve(sys, free_kf, lam):
        H_pp_d = sys["H_pp"] * (1.0 + lam) + 1e-12
        Hpp_inv = 1.0 / H_pp_d
        W = sys["W"]                                          # (P_l, 6K), local
        WHW, WHg = _reduce([(W * Hpp_inv[:, None]).t() @ W,
                            W.t() @ (Hpp_inv * sys["g_p"])], group)
        H_red = sys["H_cc"] - WHW
        g_red = sys["g_c"] - WHg
        # damping and gauge: rows and columns of fixed cameras zeroed, unit
        # diagonal (the replicated solve of local_ba._schur_solve)
        diag = torch.diagonal(H_red)
        H_red = H_red + torch.diag(diag * lam)
        m = torch.repeat_interleave(free_kf, 6).to(torch.float32)
        H_red = H_red * m[:, None] * m[None, :] + torch.diag(1.0 - m)
        g_red = g_red * m
        delta_c = torch.linalg.solve_ex(H_red, g_red).result
        delta_c = torch.where(torch.isfinite(delta_c), delta_c, torch.zeros_like(delta_c)) * m
        delta_p = Hpp_inv * (sys["g_p"] - W @ delta_c)        # local
        return delta_c, delta_p

    def solve(T_kf, free_kf, idist, point_valid, obs, delta_c, delta_e):
        deltas = (delta_c, delta_e)
        T_kf = T_kf.to(torch.float32)
        idist = idist.to(torch.float32)
        sys_c = build(T_kf, idist, obs, deltas)
        lam = 1e-5 * torch.clamp_min(torch.max(torch.diagonal(sys_c["H_cc"])), 1.0)
        nu = torch.full_like(lam, 2.0)
        for _ in range(n_iter):
            dc, dp = schur_solve(sys_c, free_kf, lam)
            T_new, id_new = _apply(T_kf, idist, dc, dp, point_valid, K)
            sys_new = build(T_new, id_new, obs, deltas)
            accept = sys_new["chi2"] < sys_c["chi2"]
            T_kf = torch.where(accept, T_new, T_kf)
            idist = torch.where(accept, id_new, idist)
            sys_c = {k: torch.where(accept, sys_new[k], v) for k, v in sys_c.items()}
            lam = torch.where(accept, lam * 0.5, torch.clamp_max(lam * nu, 1e7))
            nu = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
        return T_kf, idist, sys_c["chi2"], sys_c["rn"]

    return solve


def shard_problem(obs, idist, point_valid, n_dev: int):
    """Dense (P, K) problem → point-block layout for ``n_dev`` blocks: pure
    zero padding of P to a multiple of ``n_dev``.  Point slot s belongs to
    block ``s // p_local``; every observation cell already sits on its
    point's row.  Takes and returns tensors (numpy arrays are taken as
    tensors on the CPU).  Returns (obs_padded, idist_padded,
    point_valid_padded, p_local)."""
    obs = {k: torch.as_tensor(v) for k, v in obs.items()}
    idist = torch.as_tensor(idist)
    point_valid = torch.as_tensor(point_valid)
    p_total = idist.shape[0]
    p_local = -(-p_total // n_dev)
    pad_p = n_dev * p_local - p_total

    def pad(t):
        if not pad_p:
            return t
        return torch.cat([t, t.new_zeros((pad_p,) + tuple(t.shape[1:]))])

    return {k: pad(v) for k, v in obs.items()}, pad(idist), pad(point_valid), p_local


def distributed_bundle_adjustment(T_kf, free_kf, idist, point_valid, obs, n_kf: int,
                                  n_pts: int, n_iter: int = 10, focal: float = 450.0,
                                  strip_px: float = 2.0, n_devices: int = 0, group=None):
    """Drop-in for :func:`hso_tpu_torch.ba.local_ba.local_bundle_adjustment`
    that runs the LM loop point-sharded over the ranks of ``group`` (the
    default group; a world of one rank without a process group).  Every rank
    passes the whole problem and gets the whole result: the same dict as the
    single-device solver (T_kf, idist, obs_inlier, chi2_init, chi2_final,
    deltas), replicated.

    ``n_devices`` is the number of point blocks, on ranks 0..n_devices−1; 0
    means the world size, and more than the world size raises.  Ranks beyond
    ``n_devices`` take part in the reductions with an empty block (sums of
    zeros leave the others' bits as they are)."""
    rank, world = _world(group)
    nd = n_devices or world
    if nd > world:
        raise ValueError(f"distributed BA: {nd} point blocks asked for, but the process "
                         f"group has {world} ranks")
    T_kf = T_kf.to(torch.float32)
    idist = idist.to(torch.float32)
    deltas = compute_deltas(T_kf, idist, obs, focal)

    obs_s, idist_s, pv_s, p_local = shard_problem(
        {k: obs[k] for k in OBS_KEYS}, idist, point_valid, nd)
    lo, hi = rank * p_local, (rank + 1) * p_local
    if rank < nd:
        block = ({k: v[lo:hi] for k, v in obs_s.items()}, idist_s[lo:hi], pv_s[lo:hi])
    else:
        block = ({k: torch.zeros_like(v[:p_local]) for k, v in obs_s.items()},
                 torch.zeros_like(idist_s[:p_local]), torch.zeros_like(pv_s[:p_local]))

    solve = make_distributed_ba(n_kf, p_local, n_iter, group)
    T_f, idist_f, chi2_final, rn_f = solve(T_kf, free_kf, block[1], block[2], block[0], *deltas)
    # every rank's block of idist and residual norms, in rank order
    both = _gather(torch.cat([idist_f[:, None], rn_f], dim=1), group)
    idist_out = both[:n_pts, 0]
    rn_full = both[:n_pts, 1:]

    # chi2_init on the whole grid
    r0, _, _, _, sqrt_info = residuals_and_jacobians(T_kf, idist, obs)
    rn0 = residual_norms(r0, obs, sqrt_info)
    chi2_init = huber_chi2(rn0, obs["is_edgelet"], obs["valid"], *deltas)
    thresh = torch.where(obs["is_edgelet"], torch.full_like(rn_full, 0.6 * strip_px / focal),
                         torch.full_like(rn_full, strip_px / focal))
    obs_inlier = obs["valid"] & (rn_full <= thresh)
    return {"T_kf": T_f, "idist": idist_out, "obs_inlier": obs_inlier, "chi2_init": chi2_init,
            "chi2_final": chi2_final, "deltas": deltas}

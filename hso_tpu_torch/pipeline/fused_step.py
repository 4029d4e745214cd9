"""The per-frame step as one function.

``make_frame_step`` builds ``step(img, …)``: pyramid + Sobel construction,
coarse-to-fine 7-DoF photometric alignment (FC or IC, chosen by the
gradient-mean test), grid candidate selection with the runner-up retry
pass, batched direct matching, motion-only pose LM, scene-depth statistics
and the full depth-filter seed sweep
(:func:`hso_tpu_torch.mapping.depth_filter.update_seeds`).

``make_track_step`` is the same step without the seed sweep (the tracking
half): its ``step`` takes no ``seeds``/``px_error_angle``, the returned dict
lacks ``seeds``, ``n_seeds_updated``, ``seed_match_px``, ``seed_matched`` and
``kf_pack``, and ``packed[19]`` (seeds updated) is 0.  The whole step calls
the tracking step, so the two give the same pose bit for bit.

The map state enters as a *snapshot* dict of device tensors
(:func:`hso_tpu_torch.utils.checkpoint.snapshot_from_numpy`); heavy members
(``SNAP_HEAVY``: patch windows, positions, keyframe poses) change only at
keyframe events, ``SNAP_LIGHT`` every frame.

The FC/IC choice is a device bool and goes through
:func:`hso_tpu_torch.utils.control_flow.cond` (``jax.lax.cond`` of the JAX
step), the FC tracker's level LM through ``control_flow.gated_loop``.  Run
eagerly on the card the step waits for the device at those reads only: once
for the choice, and on an FC frame once an LM iteration.  Captured by
:class:`hso_tpu_torch.pipeline.step_graph.StepGraph` (the default on the
card) it waits on nothing: each is an IF node of the graph.  The plain
versions of the kernels read more (their loops test convergence on the host);
on the card the kernels run instead.
"""

from __future__ import annotations

import numpy as np
import torch

from hso_tpu_torch.image.pyramid import build_frame_pyramids
from hso_tpu_torch.mapping.depth_filter import update_seeds
from hso_tpu_torch.math import se3
from hso_tpu_torch.math.robust import masked_median
from hso_tpu_torch.track.coarse_tracker import make_coarse_tracker
from hso_tpu_torch.track.matcher import match_points, select_candidates
from hso_tpu_torch.track.pose_optimizer import optimize_pose
from hso_tpu_torch.utils.control_flow import cond

#: snapshot keys that change only at keyframe events (heavy, kept on the device)
SNAP_HEAVY = (
    "pos_w", "kf_poses", "kf_exposure", "ring_T", "ring_exp",
    "pt_pack", "species",
)
#: the per-frame snapshot member
SNAP_LIGHT = ("light",)

#: packed per-point patch-source row layout (snap["pt_pack"], (P, PT_COLS)
#: float32): the flattened 24×24 window, then
#:   [px 0:2 | f 2:5 | anchor 5:7 | level 7 | grad 8:10 | species 10 | kf 11]
#: ints (anchor/level/species/kf) are exact in f32 at their ranges.
PT_WIN = 24
PT_NW = PT_WIN * PT_WIN
PT_COLS = PT_NW + 12
#: snap["light"]: point lifecycle state packed into one int32 array (type in
#: bits 0-2, valid in bit 3)
TYPE_TEMPORARY = 1


def pack_light(pt_type: np.ndarray, pt_valid: np.ndarray) -> np.ndarray:
    return pt_type.astype(np.int32) + 8 * pt_valid.astype(np.int32)


def scatter_rows(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Patch rows of a device-resident snapshot table: a new tensor equal to
    ``dst`` with rows ``idx`` replaced by ``src`` (callers pad ``idx`` by
    repeating a real row, so duplicates write the same value)."""
    return dst.index_copy(0, idx.to(torch.int64), src.to(dst.dtype))


def make_track_step(cam, grid: tuple, klt_max_level: int, klt_min_level: int,
                    coarse_n_iter: int, pattern_offset: int, poseoptim_thresh: float,
                    n_obs_pad: int = 0, edgelet_cos_angle: float = 0.86,
                    align_max_iter: int = 10, patch_closest: bool = False,
                    device="cuda"):
    """Build the per-frame tracking step (no seed sweep) for a fixed
    camera/config: ``step(img, prev_pyr, prev_grad_mean, T_prev, prev_obs,
    prev_intensity, exposure_prev, T_init_rel, snap, acc)``.

    ``n_obs_pad`` > C pads the returned ``obs_next`` arrays to a fixed slot
    count.  All tensor arguments of ``step`` live on ``device``; ``img`` may
    be a numpy array."""
    device = torch.device(device)
    cell, gh, gw = grid
    C = gh * gw
    R = C // 2

    track_fc = make_coarse_tracker(
        cam, max_level=klt_max_level, min_level=klt_min_level + 1, n_iter=coarse_n_iter,
        inverse=False, pattern_offset=pattern_offset, device=device)
    track_ic = make_coarse_tracker(
        cam, max_level=klt_max_level, min_level=klt_min_level + 1, n_iter=coarse_n_iter,
        inverse=True, pattern_offset=pattern_offset, device=device)

    def step(img, prev_pyr, prev_grad_mean, T_prev, prev_obs, prev_intensity,
             exposure_prev, T_init_rel, snap, acc):
        def scalar(x):
            return torch.as_tensor(x, dtype=torch.float32, device=device).reshape(())

        prev_grad_mean = scalar(prev_grad_mean)
        prev_intensity = scalar(prev_intensity)
        exposure_prev = scalar(exposure_prev)
        data = build_frame_pyramids(img, device=device)
        lt = snap["light"]
        pt_valid = lt >= 8
        priority = lt & 7
        is_temp = priority == TYPE_TEMPORARY
        pos_w = snap["pos_w"]

        # ---- 1. coarse photometric tracking vs the previous frame ----
        pid = prev_obs["pid"].to(torch.int64)
        p_prev = se3.apply(T_prev, pos_w[pid])
        dist = torch.where(prev_obs["valid"] & (p_prev[:, 2] > 1e-5),
                           torch.linalg.norm(p_prev, dim=-1),
                           torch.full_like(p_prev[:, 0], -1.0))
        # FC vs IC by gradient mean, chosen on the device
        use_fc = data["grad_mean"] > prev_grad_mean + 0.5
        a_init = data["intensity_mean"] / torch.clamp_min(prev_intensity, 1e-6)
        tout = cond(use_fc, track_fc, track_ic,
                    (prev_pyr, data["pyr"], prev_obs["px"], prev_obs["f"], dist, T_init_rel,
                     a_init))
        T_cur = se3.mul(tout["T_cur_ref"], T_prev)
        r = tout["exposure_ratio"]
        exposure = torch.where(torch.abs(r - 1.0) < 0.01, exposure_prev, r * exposure_prev)

        # ---- 2. grid selection + batched matching with budget passes: pass 1
        # matches every cell's best candidate; pass 2 retries the cells whose
        # best FAILED with their runner-up, compacted into C//2 slots ----
        sel = select_candidates(pos_w, pt_valid, priority, T_cur, cam,
                                cell=cell, grid_h=gh, grid_w=gw)

        def cand_rows(cp, cp_valid):
            cp = cp.to(torch.int64)
            if patch_closest:
                # pick host vs latest-keyframe view by viewing angle to the
                # current camera
                p_w = pos_w[cp]
                c_cur = se3.translation(se3.inv(T_cur))

                def cosang(kf_idx):
                    c_v = se3.translation(se3.inv(snap["kf_poses"][kf_idx]))
                    a = c_v - p_w
                    b = c_cur[None, :] - p_w
                    return torch.sum(a * b, -1) / (
                        torch.linalg.norm(a, dim=-1) * torch.linalg.norm(b, dim=-1) + 1e-9)

                hp = snap["host_pack"][cp]
                pp = snap["pt_pack"][cp]
                use_host = (cosang(hp[:, PT_NW + 11].to(torch.int64))
                            > cosang(pp[:, PT_NW + 11].to(torch.int64)))
                pk = torch.where(use_host[:, None], hp, pp)
            else:
                pk = snap["pt_pack"][cp]
            win = pk[:, :PT_NW].reshape(-1, PT_WIN, PT_WIN)
            c = pk[:, PT_NW:]
            pkf = c[:, 11].to(torch.int64)
            T_p = snap["kf_poses"][pkf]
            p_in_patch = se3.apply(T_p, pos_w[cp])
            idist_p = 1.0 / torch.clamp_min(torch.linalg.norm(p_in_patch, dim=-1), 1e-9)
            return {
                "host_win": win,
                "host_anchor": c[:, 5:7].to(torch.int32),
                "host_px": c[:, 0:2],
                "host_f": c[:, 2:5],
                "host_level": c[:, 7].to(torch.int32),
                "grad": c[:, 8:10],
                "species": c[:, 10].to(torch.int32),
                "idist": idist_p,
                "T_host_w": T_p,
                "exposure_host": snap["kf_exposure"][pkf],
                "valid": cp_valid,
            }

        def match(cp, cp_valid):
            return match_points(cand_rows(cp, cp_valid), data["pyr"], data["sobel_x"],
                                data["sobel_y"], T_cur, exposure, cam,
                                edgelet_cos_angle=edgelet_cos_angle,
                                align_max_iter=align_max_iter)

        zero_c = torch.zeros((C,), dtype=torch.int32, device=device)
        cp1 = torch.where(sel["cell_valid"], sel["cell_point"], zero_c)
        m1 = match(cp1, sel["cell_valid"])
        s1 = m1["success"] & sel["cell_valid"]

        # retry slots: the earliest wanting cells in cell order.  The rank of
        # a wanting cell among the wanting cells is a cumulative sum, so the
        # compaction does not depend on how a sort or top-k breaks ties.
        want2 = sel["cell_valid2"] & ~s1
        rank = torch.cumsum(want2.to(torch.int64), dim=0) - 1
        cells = torch.arange(C, dtype=torch.int64, device=device)
        slot = torch.where(want2 & (rank < R), rank, torch.full_like(rank, R))
        ridx = torch.zeros((R + 1,), dtype=torch.int64, device=device)
        ridx.index_copy_(0, slot, cells)        # slot R collects the rest, unused
        ridx = ridx[:R]
        n_want = torch.sum(want2.to(torch.int64))
        take = torch.arange(R, dtype=torch.int64, device=device) < n_want
        cp2 = torch.where(take, sel["cell_point2"][ridx], torch.zeros_like(ridx).to(torch.int32))
        m2 = match(cp2, take)
        s2 = m2["success"] & take

        # scatter retry results back to their cells (row C collects the
        # untaken slots and is dropped)
        back_idx = torch.where(take, ridx, torch.full_like(ridx, C))

        def back(a):
            out = torch.zeros((C + 1,) + a.shape[1:], dtype=a.dtype, device=device)
            out.index_copy_(0, back_idx, a)
            return out[:C]

        use2 = back(s2)
        tried2 = back(take)
        success = s1 | use2

        def pick(a1, a2):
            u2 = use2.reshape((C,) + (1,) * (a1.ndim - 1))
            return torch.where(u2, back(a2), a1)

        cid = pick(cp1, cp2)
        m_px = pick(m1["px"], m2["px"])
        m_f = pick(m1["f_cur"], m2["f_cur"])
        m_level = pick(m1["level"], m2["level"])
        m_grad = pick(m1["grad_cur"], m2["grad_cur"])
        cid64 = cid.to(torch.int64)
        m_species = snap["species"][cid64]

        # ---- 3. motion-only pose refinement ----
        pout = optimize_pose(T_cur, pos_w[cid64], m_f, m_level, m_grad, m_species == 1,
                             is_temp[cid64], success, focal=float(cam.focal_mean),
                             reproj_thresh=poseoptim_thresh)
        T_new = pout["T_f_w"]
        inlier = pout["inlier"] & success

        # ---- 4. scene-depth statistics ----
        p_cur = se3.apply(T_new, pos_w[cid64])
        z = p_cur[:, 2]
        d = torch.linalg.norm(p_cur, dim=-1)
        ok = inlier & (z > 0)
        inf = torch.full_like(z, float("inf"))
        depth_mean = masked_median(torch.where(ok, z, inf), ok)
        depth_min = torch.min(torch.where(ok, z, inf))
        distance_mean = masked_median(torch.where(ok, d, inf), ok)

        # next frame's tracking reference: this frame's inlier matches,
        # padded to the fixed observation slot count
        pad = max(n_obs_pad - C, 0)

        def padded(a):
            if pad == 0:
                return a
            return torch.cat([a, torch.zeros((pad,) + a.shape[1:], dtype=a.dtype,
                                             device=device)], dim=0)

        obs_next = {"px": padded(m_px), "f": padded(m_f), "pid": padded(cid),
                    "valid": padded(inlier)}

        # ---- 6. result packing.  Point success/fail counters accumulate on
        # the device in ``acc`` (integer index_add_: order-independent) ----
        cp2f = torch.where(sel["cell_valid2"], sel["cell_point2"], zero_c)
        inc = torch.zeros_like(acc)
        i1 = cp1.to(torch.int64)
        i2 = cp2f.to(torch.int64)
        inc[0].index_add_(0, i1, s1.to(acc.dtype))
        inc[0].index_add_(0, i2, (tried2 & use2).to(acc.dtype))
        inc[1].index_add_(0, i1, (sel["cell_valid"] & ~s1).to(acc.dtype))
        inc[1].index_add_(0, i2, (tried2 & ~use2).to(acc.dtype))
        acc_new = acc + inc

        f32 = torch.float32
        n_matches = torch.sum(success.to(torch.int32))
        n_inliers = torch.sum(inlier.to(torch.int32))
        packed = torch.cat([
            T_new.reshape(-1).to(f32),                          # 0:12
            torch.stack([
                exposure,                                       # 12
                n_matches.to(f32),                              # 13
                n_inliers.to(f32),                              # 14
                pout["err_final_px"],                           # 15
                depth_mean, depth_min, distance_mean,           # 16, 17, 18
                torch.zeros((), dtype=f32, device=device),      # 19 seeds updated
                tout["n_tracked"].to(f32),                      # 20
                r,                                              # 21 exposure ratio
                data["grad_mean"],                              # 22
                data["intensity_mean"],                         # 23
            ]).to(f32),
        ])
        flags = (success.to(torch.int32) + 2 * inlier.to(torch.int32)
                 + 4 * sel["cell_valid"].to(torch.int32) + 8 * s1.to(torch.int32)
                 + 16 * tried2.to(torch.int32) + 32 * use2.to(torch.int32))
        slot_pack = torch.cat([
            m_px,                                               # 0, 1
            m_f,                                                # 2, 3, 4
            m_grad,                                             # 5, 6
            m_level[:, None].to(f32),                           # 7
            m_species[:, None].to(f32),                         # 8
            cid[:, None].to(f32),                               # 9
            flags[:, None].to(f32),                             # 10
        ], dim=-1)

        return {
            "packed": packed,
            "slot_pack": slot_pack,
            "acc": acc_new,
            "obs_next": obs_next,
            "data": data,
            "T_track": T_cur,
            "T_new": T_new,
            "exposure": exposure,
            "exposure_ratio": r,
            "n_tracked": tout["n_tracked"],
            "cid": cid,
            "success": success,
            "inlier": inlier,
            "cv1": sel["cell_valid"],
            "s1": s1,
            "tried2": tried2,
            "s2_used": use2,
            "cp1": cp1,
            "cp2": cp2f,
            "px": m_px,
            "f_cur": m_f,
            "level": m_level,
            "grad_cur": m_grad,
            "species": m_species,
            "err_px": pout["err_final_px"],
            "n_matches": n_matches,
            "n_inliers": n_inliers,
            "depth_mean": depth_mean,
            "depth_min": depth_min,
            "distance_mean": distance_mean,
            "used_fc": use_fc,
        }

    return step


def make_frame_step(cam, grid: tuple, klt_max_level: int, klt_min_level: int,
                    coarse_n_iter: int, pattern_offset: int, poseoptim_thresh: float,
                    n_obs_pad: int = 0, edgelet_cos_angle: float = 0.86,
                    align_max_iter: int = 10, patch_closest: bool = False,
                    device="cuda"):
    """Build the whole per-frame step for a fixed camera/config:
    ``step(img, prev_pyr, prev_grad_mean, T_prev, prev_obs, prev_intensity,
    exposure_prev, T_init_rel, snap, seeds, px_error_angle, acc)``.

    The tracking step, then the depth-filter sweep of ``seeds`` (a table as
    :func:`hso_tpu_torch.mapping.depth_filter.empty_seeds` lays it out)
    against the new frame at the refined pose.  The dict gains ``seeds``,
    ``n_seeds_updated``, ``seed_match_px``, ``seed_matched``, ``packed[19]``
    and ``kf_pack``: slot results, lifecycle accumulators and seed match
    statistics in ONE flat float32 buffer, laid out
    ``[slot_pack (C·11) | acc (2P) | seed_match_px (2S) | seed_matched (S)]``
    for a single device→host copy at keyframe events."""
    track = make_track_step(cam, grid, klt_max_level, klt_min_level, coarse_n_iter,
                            pattern_offset, poseoptim_thresh, n_obs_pad, edgelet_cos_angle,
                            align_max_iter, patch_closest, device)

    def step(img, prev_pyr, prev_grad_mean, T_prev, prev_obs, prev_intensity,
             exposure_prev, T_init_rel, snap, seeds, px_error_angle, acc):
        out = track(img, prev_pyr, prev_grad_mean, T_prev, prev_obs, prev_intensity,
                    exposure_prev, T_init_rel, snap, acc)
        data = out["data"]

        # ---- 5. depth-filter observation sweep ----
        seeds_new, sstats = update_seeds(
            seeds, snap["ring_T"], snap["ring_exp"], data["pyr"], data["sobel_x"],
            data["sobel_y"], out["T_new"], out["exposure"], px_error_angle, cam)

        f32 = torch.float32
        packed = out["packed"].clone()
        packed[19] = sstats["n_updated"].to(f32)
        out["packed"] = packed
        out["kf_pack"] = torch.cat([
            out["slot_pack"].reshape(-1),
            out["acc"].reshape(-1).to(f32),
            sstats["px_match"].reshape(-1),
            sstats["matched"].to(f32),
        ])
        out["seeds"] = seeds_new
        out["n_seeds_updated"] = sstats["n_updated"]
        out["seed_match_px"] = sstats["px_match"]
        out["seed_matched"] = sstats["matched"]
        return out

    return step

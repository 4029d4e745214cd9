"""Covisibility window selection, BA problem assembly and write-back.

Host-side glue between the map model and the device BA solver
(:func:`hso_tpu_torch.ba.local_ba.local_bundle_adjustment`):

  * core = keyframes sharing ≥ threshold points with the centre keyframe (top
    ``core_n_kfs``), plus the last keyframe and the centre;
  * keyframe 0 and keyframes older than 20 keyframe ids are held fixed;
    hosts and targets outside the core enter as fixed vertices;
  * observations = every (keyframe, feature slot) referencing a windowed
    point, host frames excluded (the host constraint enters through the
    inverse-distance parameterisation);
  * after the solve: inverse-distance write-back (poses only with
    ``cfg.loba_pose_writeback``) and outlier-observation stripping.

The problem goes to the device in one non-blocking copy per member and the
solver's outputs come back in one device→host copy.  Host iteration order is fixed
(``set`` of ints, counts sorted by (-count, keyframe)), so the problem is the
same from run to run.
"""

from __future__ import annotations

import numpy as np
import torch

from hso_tpu_torch.ba.local_ba import local_bundle_adjustment
from hso_tpu_torch.math import se3np

#: optional observer called with (args, kwargs) of every windowed-BA solve
#: (the tests and the bench read the problem through it)
solve_capture = None


def covisible_keyframes(handler, center) -> list[int]:
    """Keyframes sharing map points with the centre, counted through the
    inverted point→observers index (never a scan over all keyframes)."""
    o = center.obs
    seen = o["point_id"][o["valid"] & (o["point_id"] >= 0)].tolist()
    if not seen:
        return []
    pts = handler.points
    frames = handler.kfs.frames
    counter: dict[int, int] = {}
    for p in set(seen):
        for kf, _ in pts.live_obs(p, frames):
            if kf != center.kf_index:
                counter[kf] = counter.get(kf, 0) + 1
    counts = sorted(counter.items(), key=lambda t: (-t[1], t[0]))
    th = 5 if len(set(seen)) > 30 else 3
    core = [k for k, c in counts if c >= th][: handler.cfg.core_n_kfs]
    if not core and counts:
        core = [counts[0][0]]
    last_kf = frames[-2].kf_index if len(frames) > 1 else None
    if last_kf is not None and last_kf not in core:
        core.append(last_kf)
    return core


def run_local_ba(handler, center) -> dict | None:
    """Assemble the windowed BA problem around keyframe ``center``, solve it on
    ``handler.device`` and write the result back into the host map.  Returns
    the problem's counts and chi2, or None when the window is too small."""
    cfg = handler.cfg
    if cfg.distributed_ba:
        raise NotImplementedError("distributed BA is not ported")
    K = cfg.n_kfs_window
    P = cfg.n_points_ba_max

    core = covisible_keyframes(handler, center)
    window = core + [center.kf_index]

    # ---- points observed by the window ----
    pts = handler.points
    point_set: list[int] = []
    point_slot = {}
    for k in window:
        ko = handler.kfs.frames[k].obs
        for p in ko["point_id"][ko["valid"] & (ko["point_id"] >= 0)].tolist():
            if p not in point_slot and pts.valid[p]:
                if len(point_set) >= P:
                    break
                point_slot[p] = len(point_set)
                point_set.append(p)

    if len(point_set) < 8:
        return None

    # ---- keyframe slots: the window first (free by the fixation rules), then
    # fixed hosts and targets as they come ----
    kf_slot = {}
    free_flags = []

    def slot_of(kf_idx: int, free: bool) -> int | None:
        if kf_idx in kf_slot:
            return kf_slot[kf_idx]
        if len(kf_slot) >= K:
            return None
        kf_slot[kf_idx] = len(kf_slot)
        free_flags.append(free)
        return kf_slot[kf_idx]

    center_id = center.kf_index
    for k in window:
        is_free = not (k == 0 or k + 20 < center_id)
        slot_of(k, is_free)
    # points whose host keyframe gets no slot (window overflow) leave this round
    kept = []
    for p in point_set:
        if slot_of(int(pts.host_kf[p]), False) is not None:
            kept.append(p)
        else:
            del point_slot[p]
    point_set = kept
    point_slot = {p: i for i, p in enumerate(point_set)}
    if len(point_set) < 8:
        return None

    # ---- observation cells: every live observation of a windowed point
    # (through the inverted index), host frame excluded, at its
    # (point slot, keyframe slot) cell ----
    frames = handler.kfs.frames
    meas = np.zeros((P, K, 2), np.float32)
    grad = np.zeros((P, K, 2), np.float32)
    is_edge = np.zeros((P, K), bool)
    level = np.zeros((P, K), np.int32)
    valid = np.zeros((P, K), bool)
    f_host = np.zeros((P, 3), np.float32)
    host_col = np.zeros(P, np.int32)
    src_kf = np.full((P, K), -1, np.int32)   # write-back: cell → (kf, feature)
    src_i = np.full((P, K), -1, np.int32)

    n_obs = 0
    for p in point_set:
        s = point_slot[p]
        host = int(pts.host_kf[p])
        host_col[s] = kf_slot[host]
        f_host[s] = pts.host_f[p]
        for kf_idx, i in pts.live_obs(p, frames):
            if kf_idx == host:
                continue
            t = slot_of(kf_idx, False)
            if t is None:
                continue
            ko = frames[kf_idx].obs
            # at most one live observation per (point, keyframe)
            assert not valid[s, t], (
                f"duplicate observation of point {p} in keyframe {kf_idx}")
            f = ko["f"][i]
            meas[s, t] = f[:2] / max(f[2], 1e-9)
            grad[s, t] = ko["grad"][i]
            is_edge[s, t] = ko["species"][i] == 1
            level[s, t] = ko["level"][i]
            valid[s, t] = True
            src_kf[s, t] = kf_idx
            src_i[s, t] = i
            n_obs += 1

    if n_obs < 8:
        return None

    # ---- pack keyframes / points ----
    T_kf = np.tile(se3np.identity()[None], (K, 1, 1)).astype(np.float32)
    free = np.zeros(K, bool)
    for kf_idx, s in kf_slot.items():
        T_kf[s] = handler.kfs.poses[kf_idx]
        free[s] = free_flags[s]
    idist = np.zeros(P, np.float32)
    pvalid = np.zeros(P, bool)
    for p, s in point_slot.items():
        idist[s] = pts.idist[p]
        pvalid[s] = True

    h2d = handler._h2d        # non-blocking copies from pinned memory on the card
    obs = {"meas": h2d(meas), "grad": h2d(grad), "is_edgelet": h2d(is_edge),
           "level": h2d(level), "valid": h2d(valid), "f_host": h2d(f_host),
           "host": h2d(host_col)}
    n_iter = cfg.loba_num_iter
    if len(handler.kfs.frames) <= 5:
        n_iter = 30
    args_c = (h2d(T_kf), h2d(free), h2d(idist), h2d(pvalid), obs)
    kw = dict(n_kf=K, n_pts=P, n_iter=n_iter, focal=float(handler.cam.focal_mean),
              strip_px=float(cfg.loba_thresh))
    if solve_capture is not None:
        solve_capture(args_c, kw)
    out = local_bundle_adjustment(*args_c, **kw)

    # ---- write-back (one device→host copy for all solver outputs) ----
    f32 = torch.float32
    buf = torch.cat([
        out["T_kf"].reshape(-1).to(f32), out["idist"].to(f32),
        out["obs_inlier"].reshape(-1).to(f32),
        torch.stack([out["chi2_init"], out["chi2_final"]]).to(f32),
    ]).cpu().numpy().astype(np.float64)
    nT = K * 12
    T_new = buf[:nT].reshape(K, 3, 4)
    id_new = buf[nT:nT + P]
    inl = buf[nT + P:nT + P + P * K].reshape(P, K) > 0.5
    chi2_init, chi2_final = buf[-2], buf[-1]
    # pose write-back is off by default (Config.loba_pose_writeback): the
    # tracked chain keeps its pre-BA poses, and the centre frame's device pose
    # and observation set stay a consistent pair for the next coarse track;
    # the BA correction reaches the next frame through the snapshot's
    # kf_poses/pos_w
    for kf_idx, s in kf_slot.items():
        if free[s] and cfg.loba_pose_writeback:
            handler.kfs.sync_pose(kf_idx, se3np.normalize(T_new[s]))
            if kf_idx == center.kf_index:
                center.T_f_w = handler.kfs.poses[kf_idx]
    for p, s in point_slot.items():
        if id_new[s] > 1e-10:
            pts.idist[p] = id_new[s]
    n_strip = 0
    bad = np.nonzero(~inl & (src_kf >= 0))
    for s, t_ in zip(*bad):
        ko = handler.kfs.frames[src_kf[s, t_]].obs
        ko["point_id"][src_i[s, t_]] = -1
        ko["valid"][src_i[s, t_]] = False
        n_strip += 1

    return {
        "n_obs": n_obs,
        "n_points": len(point_set),
        "n_kfs": len(kf_slot),
        "n_stripped": n_strip,
        "chi2_init": float(chi2_init),
        "chi2_final": float(chi2_final),
    }

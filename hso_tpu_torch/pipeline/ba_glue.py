"""Covisibility window selection, BA problem assembly and write-back.

Host-side glue between the map model and the device BA solver
(:func:`hso_tpu_torch.ba.local_ba.local_bundle_adjustment`, or with
``cfg.distributed_ba`` the point-sharded
:func:`hso_tpu_torch.ba.distributed.distributed_bundle_adjustment`):

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
solver's outputs come back in one device→host copy.  The solve itself is,
for a handler whose step runs as a graph, a captured CUDA graph from the
handler's cache keyed by ``(n_kf, n_pts, n_iter, focal, strip_px)``
(:func:`captured_local_ba`, the JAX package's ``_jitted_local_ba``): one
replay instead of some four thousand launches, captured at the first solve
of its key, so a handler pays only for the keys it solves.  The point-sharded
solve stays eager (it runs collectives).  Host iteration order is fixed
(``set`` of ints, counts sorted by (-count, keyframe)), so the problem is the
same from run to run.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from hso_tpu_torch.ba.distributed import distributed_bundle_adjustment
from hso_tpu_torch.ba.local_ba import local_bundle_adjustment
from hso_tpu_torch.math import se3np
from hso_tpu_torch.pipeline.step_graph import StepGraph

#: optional observer called with (args, kwargs) of every windowed-BA solve
#: (the tests and the bench read the problem through it)
solve_capture = None


#: the solver's static arguments, in the order of a cache key
BA_KEY = ("n_kf", "n_pts", "n_iter", "focal", "strip_px")


def captured_local_ba(cache: dict, device, **kw) -> StepGraph:
    """The windowed BA solve for the static arguments ``kw`` (:data:`BA_KEY`)
    from ``cache``, made on first use: a :class:`StepGraph` with one instance
    (the handler reads each result back before the next solve), captured at
    its first call and replayed after.  On the CPU the instance calls the
    solver on its staged inputs."""
    key = tuple(kw[k] for k in BA_KEY)
    if key not in cache:
        cache[key] = StepGraph(functools.partial(local_bundle_adjustment, **kw), device,
                               instances=1, image=False)
    return cache[key]


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
    the problem's counts and chi2, or None when the window is too small.
    Traced as three spans of the handler: ``ba_assemble`` (the window, the
    points and the observation cells, on the host), ``ba_solve`` (the uploads
    and the solve; its device span ``ba_solve``, the solve alone) and
    ``ba_readback`` (the one read of the solver's outputs, the write-back and
    the stripping); the problem's size is logged as ``ba_obs`` and
    ``ba_points``."""
    with handler._t("ba_assemble"):
        prob = assemble(handler, center)
    if prob is None:
        return None
    if handler.monitor is not None:
        handler.monitor.log("ba_obs", prob["n_obs"])
        handler.monitor.log("ba_points", len(prob["point_set"]))
    with handler._t("ba_solve"):
        out = solve(handler, prob)
    with handler._t("ba_readback"):
        return write_back(handler, center, prob, out)


def assemble(handler, center) -> dict | None:
    """The windowed BA problem around keyframe ``center`` as host arrays, with
    the slots the write-back needs; None when the window is too small."""
    cfg = handler.cfg
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
    n_iter = cfg.loba_num_iter
    if len(handler.kfs.frames) <= 5:
        n_iter = 30
    return dict(T_kf=T_kf, free=free, idist=idist, pvalid=pvalid,
                obs=dict(meas=meas, grad=grad, is_edgelet=is_edge, level=level, valid=valid,
                         f_host=f_host, host=host_col),
                kw=dict(n_kf=K, n_pts=P, n_iter=n_iter, focal=float(handler.cam.focal_mean),
                        strip_px=float(cfg.loba_thresh)),
                n_obs=n_obs, point_set=point_set, point_slot=point_slot, kf_slot=kf_slot,
                src_kf=src_kf, src_i=src_i)


def solve(handler, prob: dict) -> dict:
    """Upload the problem (one non-blocking copy a member on the card) and
    solve it on ``handler.device``: the solver's device outputs."""
    cfg = handler.cfg
    h2d = handler._h2d        # non-blocking copies from pinned memory on the card
    obs = {k: h2d(v) for k, v in prob["obs"].items()}
    args_c = (h2d(prob["T_kf"]), h2d(prob["free"]), h2d(prob["idist"]), h2d(prob["pvalid"]),
              obs)
    kw = prob["kw"]
    if solve_capture is not None:
        solve_capture(args_c, kw)
    if cfg.distributed_ba:
        # point-sharded over the ranks of the default process group (one
        # rank without a group); every rank gets the whole result
        work = functools.partial(distributed_bundle_adjustment, n_devices=cfg.ba_n_devices,
                                 **kw)
    elif handler._graph:
        work = captured_local_ba(handler._ba_solves, handler.device, **kw)
    else:
        work = functools.partial(local_bundle_adjustment, **kw)
    return handler._run(work, args_c, "ba_solve")


def write_back(handler, center, prob: dict, out: dict) -> dict:
    """Read the solver's outputs in one device→host copy and write them into
    the host map: inverse distances (poses only with
    ``cfg.loba_pose_writeback``), then strip the outlier observations."""
    cfg = handler.cfg
    pts = handler.points
    K, P = prob["kw"]["n_kf"], prob["kw"]["n_pts"]
    kf_slot, point_slot, free = prob["kf_slot"], prob["point_slot"], prob["free"]
    src_kf, src_i = prob["src_kf"], prob["src_i"]
    f32 = torch.float32
    buf = handler._d2h(torch.cat([
        out["T_kf"].reshape(-1).to(f32), out["idist"].to(f32),
        out["obs_inlier"].reshape(-1).to(f32),
        torch.stack([out["chi2_init"], out["chi2_final"]]).to(f32),
    ])).astype(np.float64)
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
        "n_obs": prob["n_obs"],
        "n_points": len(prob["point_set"]),
        "n_kfs": len(kf_slot),
        "n_stripped": n_strip,
        "chi2_init": float(chi2_init),
        "chi2_final": float(chi2_final),
    }

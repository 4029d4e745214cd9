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
solve stays eager (it runs collectives).

The assembly and the write-back are array operations over the map's
keyframe-major observation table (:class:`KeyframeWindow`: one row of
observation cells a keyframe, each cell admitted by ``register_obs`` while it
stays valid with the same point), with no loop over points or observations.
Every order is fixed (counts sorted by (-count, keyframe), first occurrences,
cells in (point, keyframe, slot) order), so the problem is the same from run
to run.
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
    """Keyframes sharing map points with the centre: for each keyframe, the
    count of its live cells (:meth:`KeyframeWindow.live`) that hold a point
    the centre sees, the centre's own excluded; only the rows that can hold
    those points' cells are read (:meth:`PointTable.obs_rows`)."""
    o = center.obs
    seen = o["point_id"][o["valid"] & (o["point_id"] >= 0)]
    if not len(seen):
        return []
    kfs, pts = handler.kfs, handler.points
    mark = np.zeros(pts.p_max, bool)
    mark[seen] = True
    lo, hi = pts.obs_rows(seen)
    live = kfs.live(lo, hi)
    # a cell that is not live may hold -1 (mark's last entry): masked out
    held = live & np.take(mark, kfs.obs["point_id"][lo:lo + len(live)])
    n_cells = np.zeros(len(kfs.frames), np.int64)
    n_cells[lo:lo + len(live)] = np.count_nonzero(held, axis=1)
    n_cells[center.kf_index] = 0
    ks = np.nonzero(n_cells)[0]
    ks = ks[np.lexsort((ks, -n_cells[ks]))]            # by (-count, keyframe)
    th = 5 if int(mark.sum()) > 30 else 3
    core = ks[n_cells[ks] >= th][: handler.cfg.core_n_kfs].tolist()
    if not core and len(ks):
        core = [int(ks[0])]
    frames = kfs.frames
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
    the slots the write-back needs; None when the window is too small.  Array
    operations over the keyframe-major observation table
    (:class:`KeyframeWindow`): no loop over points or observations."""
    cfg = handler.cfg
    K = cfg.n_kfs_window
    P = cfg.n_points_ba_max
    kfs, pts = handler.kfs, handler.points

    window = covisible_keyframes(handler, center) + [center.kf_index]

    # ---- points observed by the window: valid points in window order, first
    # occurrence, at most P ----
    pid = kfs.obs["point_id"][window]
    seen = pid[kfs.obs["valid"][window] & (pid >= 0)]
    seen = seen[pts.valid[seen]]
    point_set = seen[np.sort(np.unique(seen, return_index=True)[1])[:P]]
    if len(point_set) < 8:
        return None

    # ---- keyframe slots: the window first (free by the fixation rules), then
    # fixed hosts and targets in the order the points and cells meet them ----
    slot = np.full(kfs.k_all_max, -1, np.int64)        # keyframe → slot
    kf_slot: dict[int, int] = {}
    free = np.zeros(K, bool)
    center_id = center.kf_index
    for k in window:
        if k not in kf_slot and len(kf_slot) < K:
            slot[k] = kf_slot[k] = len(kf_slot)
            free[slot[k]] = not (k == 0 or k + 20 < center_id)

    def fixed_slots(kf_seq):
        """Slots for the keyframes of ``kf_seq`` that have none, in order of
        first appearance, while slots last."""
        new = kf_seq[slot[kf_seq] < 0]
        new = new[np.sort(np.unique(new, return_index=True)[1])][: K - len(kf_slot)]
        for k in new.tolist():
            slot[k] = kf_slot[k] = len(kf_slot)

    host = pts.host_kf[point_set]
    fixed_slots(host)
    # points whose host keyframe gets no slot (window overflow) leave this round
    kept = slot[host] >= 0
    point_set, host = point_set[kept], host[kept]
    n_p = len(point_set)
    if n_p < 8:
        return None

    # ---- observation cells: every live cell of a windowed point, host frame
    # excluded, at its (point slot, keyframe slot), in (point, keyframe, slot)
    # order: the order in which the inverted index lists a point's cells ----
    point_slot = np.full(pts.p_max, -1, np.int64)
    point_slot[point_set] = np.arange(n_p)
    lo, hi = pts.obs_rows(point_set)
    live = kfs.live(lo, hi)
    rows = kfs.obs["point_id"][lo:lo + len(live)]
    # a cell that is not live may hold -1 (point_slot's last entry): masked out
    cell = np.flatnonzero(live & (np.take(point_slot, rows) >= 0))
    kf_c, i_c = np.divmod(cell, rows.shape[1])
    kf_c += lo
    s_c = point_slot[rows.ravel()[cell]]
    m = kf_c != host[s_c]
    order = np.argsort(s_c[m], kind="stable")
    kf_c, i_c, s_c = kf_c[m][order], i_c[m][order], s_c[m][order]
    fixed_slots(kf_c)
    t_c = slot[kf_c]
    m = t_c >= 0
    kf_c, i_c, s_c, t_c = kf_c[m], i_c[m], s_c[m], t_c[m]
    # at most one live observation per (point, keyframe)
    cells, first, count = np.unique(s_c * K + t_c, return_index=True, return_counts=True)
    if (count > 1).any():
        d = first[np.argmax(count > 1)]
        raise AssertionError(
            f"duplicate observation of point {point_set[s_c[d]]} in keyframe {kf_c[d]}")
    n_obs = len(cells)
    if n_obs < 8:
        return None

    meas = np.zeros((P, K, 2), np.float32)
    grad = np.zeros((P, K, 2), np.float32)
    is_edge = np.zeros((P, K), bool)
    level = np.zeros((P, K), np.int32)
    valid = np.zeros((P, K), bool)
    src_kf = np.full((P, K), -1, np.int32)   # write-back: cell → (kf, feature)
    src_i = np.full((P, K), -1, np.int32)
    f = kfs.obs["f"][kf_c, i_c]
    meas[s_c, t_c] = f[:, :2] / np.maximum(f[:, 2:], np.float32(1e-9))
    grad[s_c, t_c] = kfs.obs["grad"][kf_c, i_c]
    is_edge[s_c, t_c] = kfs.obs["species"][kf_c, i_c] == 1
    level[s_c, t_c] = kfs.obs["level"][kf_c, i_c]
    valid[s_c, t_c] = True
    src_kf[s_c, t_c] = kf_c
    src_i[s_c, t_c] = i_c
    f_host = np.zeros((P, 3), np.float32)
    f_host[:n_p] = pts.host_f[point_set]
    host_col = np.zeros(P, np.int32)
    host_col[:n_p] = slot[host]

    # ---- pack keyframes / points ----
    T_kf = np.tile(se3np.identity()[None], (K, 1, 1)).astype(np.float32)
    T_kf[:len(kf_slot)] = kfs.poses[list(kf_slot)]
    idist = np.zeros(P, np.float32)
    idist[:n_p] = pts.idist[point_set]
    pvalid = np.zeros(P, bool)
    pvalid[:n_p] = True
    n_iter = cfg.loba_num_iter
    if len(kfs.frames) <= 5:
        n_iter = 30
    return dict(T_kf=T_kf, free=free, idist=idist, pvalid=pvalid,
                obs=dict(meas=meas, grad=grad, is_edgelet=is_edge, level=level, valid=valid,
                         f_host=f_host, host=host_col),
                kw=dict(n_kf=K, n_pts=P, n_iter=n_iter, focal=float(handler.cam.focal_mean),
                        strip_px=float(cfg.loba_thresh)),
                n_obs=n_obs, point_set=point_set, kf_slot=kf_slot, src_kf=src_kf, src_i=src_i)


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
    kf_slot, free, point_set = prob["kf_slot"], prob["free"], prob["point_set"]
    src_kf, src_i = prob["src_kf"], prob["src_i"]
    f32 = torch.float32
    buf = handler._d2h(torch.cat([
        out["T_kf"].reshape(-1).to(f32), out["idist"].to(f32),
        out["obs_inlier"].reshape(-1).to(f32),
        torch.stack([out["chi2_init"], out["chi2_final"]]).to(f32),
    ])).astype(np.float64)
    nT = K * 12
    T_new = buf[:nT].reshape(K, 3, 4)
    id_new = buf[nT:nT + len(point_set)]
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
    up = id_new > 1e-10
    pts.idist[point_set[up]] = id_new[up]
    bad = ~inl & (src_kf >= 0)
    handler.kfs.clear_cells(src_kf[bad], src_i[bad])
    n_strip = int(bad.sum())

    return {
        "n_obs": prob["n_obs"],
        "n_points": len(prob["point_set"]),
        "n_kfs": len(kf_slot),
        "n_stripped": n_strip,
        "chi2_init": float(chi2_init),
        "chi2_final": float(chi2_final),
    }

"""The keyframe work of the evolving-map scan, on the device.

``keyframe_work`` runs after the per-frame step at a keyframe event, in this
order:

  1. the keyframe pose registry and the seed-host ring take the new pose;
  2. the frame's inlier matches register into their column of the dense
     (P_T, K, 7) observation ring (column = keyframe index mod K), which
     evicts the keyframe that left the window;
  3. the window is the last K keyframes, the oldest ``N_FIX_GAUGE`` (and
     keyframe 0) held fixed; its points are compacted to ``P_BA`` rows, solved
     by the windowed Schur BA (:mod:`hso_tpu_torch.ba.local_ba`), and the
     solution is written back: keyframe poses, inverse distances, the
     outlier-stripped observations and the re-anchored world positions;
  4. the seed table is harvested and pruned, and up to ``R_ACT`` converged
     seeds are activated into the reserved ring of ``R_RES`` point rows
     (position, anchoring, a 24×24 cut of the 44×44 host window; the row's
     observation cells are emptied, which the JAX bench does not do);
  5. detection on the new keyframe (cells holding an inlier match are
     occupied) fills the seed table's free slots.

The map state ``st`` is laid out by
:func:`hso_tpu_torch.utils.checkpoint.scan_state_from_checkpoint`.  Its
counters ``kf_count`` and ``batch`` are host ints (they advance by one a
keyframe), so the body never waits on the device; the activation cursor is
a device tensor.  Masked writes go to the last point row (the trash row),
which is reset to an empty row afterwards, so repeated indices never reach a
live row.  Compaction keeps the candidates in index order, then the other
rows in index order, by a cumulative-sum rank (no sort, no tie to break).
Every function returns new tensors and leaves its inputs untouched.
"""

from __future__ import annotations

import torch

from hso_tpu_torch.ba.local_ba import local_bundle_adjustment
from hso_tpu_torch.mapping.depth_filter import harvest_and_prune, init_seeds
from hso_tpu_torch.math import se3
from hso_tpu_torch.ops.detect import detect_features, occupancy_grid

SEED_RING = 8            #: host keyframes of the seed table (ring slots)
R_RES = 512              #: point rows reserved for activated seeds (a ring)
R_ACT = 64               #: activations per keyframe, at most
N_FIX_GAUGE = 4          #: oldest window keyframes held fixed (gauge)
TYPE_CAND_VALID = 8 + 2  #: the light word of a valid CANDIDATE point
PT_WIN = 24              #: the point table's window edge
DETECT_CELL = 32         #: detection cell edge at level 0
DETECT_LEVELS = 3        #: pyramid levels searched by detection and host windows


def first_rows(cand: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the first ``k`` rows when the rows of ``cand`` come first in
    index order and the others follow in index order (what a top-k over
    ``where(cand, n - arange(n), 0)`` gives), from a cumulative-sum rank."""
    n = cand.shape[0]
    c = cand.to(torch.int64)
    n_cand = torch.sum(c)
    pos = torch.where(cand, torch.cumsum(c, 0) - 1, n_cand + torch.cumsum(1 - c, 0) - 1)
    order = torch.empty((n,), dtype=torch.int64, device=cand.device)
    order.index_copy_(0, pos, torch.arange(n, dtype=torch.int64, device=cand.device))
    return order[:k]


def _put(dst: torch.Tensor, idx, src) -> torch.Tensor:
    """A copy of ``dst`` with rows ``idx`` set to ``src`` (a tensor or a
    Python number: a number is a fill, not a copy from the host)."""
    out = dst.clone()
    out[idx] = src.to(dst.dtype) if isinstance(src, torch.Tensor) else src
    return out


def keyframe_work(st, seeds, out, cam, cfg):
    """The keyframe body after a step: ``st`` the map state, ``seeds`` the
    step's swept seed table, ``out`` the step's output dict.

    Returns ``(st', seeds', chk, stats)``: ``chk`` the device scalar
    Σ detection scores + BA chi2 + activations; ``stats`` device scalars
    (``chi2_init``, ``chi2_final``, ``activated``, ``seeds_initialised``,
    ``ba_points``, ``detected``) and the rows the BA was compacted to
    (``rows_b``) and the seed rows considered for activation (``rows_act``)."""
    dev = st["light"].device
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    st = dict(st)
    data = out["data"]
    p_t = st["light"].shape[0]
    trash = p_t - 1
    p0 = p_t - R_RES - 1
    kw = int(cfg.n_kfs_window)
    p_ba = int(cfg.n_points_ba_max)
    focal = float(cam.focal_mean)
    kf_idx = int(st["kf_count"])
    batch = int(st["batch"])
    slot = batch % SEED_RING

    # ---- 1. pose registry and seed-host ring
    st["kf_poses"] = _put(st["kf_poses"], kf_idx, out["T_new"])
    st["kf_exposure"] = _put(st["kf_exposure"], kf_idx, out["exposure"])
    st["ring_T"] = _put(st["ring_T"], slot, out["T_new"])
    st["ring_exp"] = _put(st["ring_exp"], slot, out["exposure"])
    st["ring_kf"] = _put(st["ring_kf"], slot, kf_idx)

    # ---- 2. register this keyframe's inlier matches into its ring column
    col = kf_idx % kw
    ok_slot = out["success"] & out["inlier"]
    pid = torch.where(ok_slot, out["cid"].to(i64),
                      torch.full_like(out["cid"], trash, dtype=i64))
    f_c = out["f_cur"]
    meas = f_c[:, :2] / torch.clamp_min(f_c[:, 2:3], 1e-9)
    row = torch.cat([meas, out["grad_cur"], (out["species"] == 1).to(f32)[:, None],
                     out["level"].to(f32)[:, None], ok_slot.to(f32)[:, None]], dim=1)
    ba_pack = st["ba_pack"].clone()
    ba_pack[:, col] = 0.0
    ba_pack[pid, col] = row
    ba_pack[trash] = 0.0

    # ---- 3. the window: the last K keyframes by ring column (made on the
    # device from host ints: a copy from the host would wait for the device)
    base = kf_idx + 1 - kw
    g_col = base + torch.remainder(torch.arange(kw, device=dev) - base, kw)
    col_live = g_col >= 0
    free = col_live & (g_col != 0) & (g_col >= base + N_FIX_GAUGE)
    g_col = torch.clamp_min(g_col, 0)
    T_win = st["kf_poses"][g_col]
    host_kf = st["host_kf"]
    pvalid = (st["light"] >= 8) & (host_kf >= max(base, 0)) & (host_kf <= kf_idx)
    host_slot = torch.remainder(torch.clamp_min(host_kf, 0), kw)
    obs_on = (ba_pack[..., 6] > 0.5) & col_live[None, :]
    obs_valid = (obs_on & pvalid[:, None]
                 & (torch.arange(kw, device=dev)[None, :] != host_slot[:, None]))
    # compact to P_BA rows: the windowed points with an observation, in index
    # order, then other rows (never valid) to fill
    cand_b = pvalid & torch.any(obs_on, dim=1)
    rows_b = first_rows(cand_b, p_ba)
    pv_b = cand_b[rows_b]
    pk_b = ba_pack[rows_b]
    obs_b = {"meas": pk_b[..., 0:2], "grad": pk_b[..., 2:4], "is_edgelet": pk_b[..., 4] > 0.5,
             "level": pk_b[..., 5].to(i32), "valid": obs_valid[rows_b],
             "f_host": st["f_host"][rows_b], "host": host_slot[rows_b]}
    ba = local_bundle_adjustment(T_win, free, st["idist"][rows_b], pv_b, obs_b, n_kf=kw,
                                 n_pts=p_ba, n_iter=int(cfg.loba_num_iter), focal=focal)

    # write back: free window poses, inverse distances, outlier-stripped
    # observations, re-anchored world positions (rows_b holds no repeats)
    upd = (col_live & free)[:, None, None]
    st["kf_poses"] = _put(st["kf_poses"], g_col, torch.where(upd, ba["T_kf"], T_win))
    id_ok_b = pv_b & (ba["idist"] > 1e-10)
    st["idist"] = _put(st["idist"], rows_b,
                       torch.where(id_ok_b, ba["idist"], st["idist"][rows_b]))
    keep_b = (pk_b[..., 6] > 0.5) & (ba["obs_inlier"] | ~obs_b["valid"])
    ba_pack[rows_b, :, 6] = torch.where(id_ok_b[:, None], keep_b.to(f32), pk_b[..., 6])
    st["ba_pack"] = ba_pack
    id_ok = torch.zeros((p_t,), dtype=torch.bool, device=dev)
    id_ok[rows_b] = id_ok_b
    T_h = st["kf_poses"][torch.clamp_min(host_kf, 0).to(i64)]
    pos_ba = se3.apply(se3.inv(T_h), st["f_host"] / torch.clamp_min(st["idist"], 1e-9)[:, None])
    st["pos_w"] = torch.where(id_ok[:, None], pos_ba.to(f32), st["pos_w"])

    # ---- 4. seed harvest, then activation of converged seeds into the ring
    seeds2, bundle = harvest_and_prune(seeds, batch, st["ring_T"], cfg.max_seed_kf_batches,
                                       4.0, focal)
    conv = bundle[:, 0] > 0.5
    rows = first_rows(conv, R_ACT)
    taken = conv[rows]
    b_r = bundle[rows]
    h_slot = b_r[:, 2].to(i64)
    mu = torch.clamp_min(b_r[:, 12], 1e-9)
    f_s = b_r[:, 5:8]
    pos_new = se3.apply(se3.inv(st["ring_T"][h_slot]), f_s / mu[:, None])
    off = torch.cumsum(taken.to(i64), 0) - 1
    tgt = torch.where(taken, p0 + torch.remainder(st["cursor"].to(i64) + off, R_RES),
                      torch.full_like(off, trash))
    host_of = st["ring_kf"][h_slot]
    c0 = (seeds["host_win"].shape[-1] - PT_WIN) // 2
    new_rows = torch.cat([
        seeds["host_win"][rows, c0:c0 + PT_WIN, c0:c0 + PT_WIN].reshape(R_ACT, -1),
        b_r[:, 3:5],                                              # px
        f_s,                                                      # f
        (seeds["host_anchor"][rows] + c0).to(f32),                # anchor
        b_r[:, 8:9],                                              # level
        b_r[:, 10:12],                                            # grad
        b_r[:, 9:10],                                             # species
        host_of[:, None].to(f32),                                 # keyframe
    ], dim=1)
    writes = {
        "pos_w": (pos_new.to(f32), 0),
        "light": (torch.full_like(taken, TYPE_CAND_VALID, dtype=i32), 0),
        "f_host": (f_s, 0),
        "host_kf": (torch.where(taken, host_of, torch.full_like(host_of, -1)), -1),
        "idist": (mu, 0),
        "pt_pack": (new_rows, 0),
        "species": (b_r[:, 9], 0),
        # a reused ring row starts with no observation cells: the ones it
        # holds were registered for the point that held the row before
        "ba_pack": (0.0, 0),
    }
    for k, (vals, empty) in writes.items():
        t = _put(st[k], tgt, vals)
        t[trash] = empty                 # the trash row absorbed the masked writes
        st[k] = t
    n_act = torch.sum(taken.to(i32))
    st["cursor"] = torch.remainder(st["cursor"] + n_act, R_RES).to(i32)

    # ---- 5. detection (cells holding an inlier match are occupied) → seeds
    occ = occupancy_grid(out["px"], out["inlier"], cam.height, cam.width, DETECT_CELL)
    det = detect_features(data["pyr"][:DETECT_LEVELS], data["sobel_x"], data["sobel_y"],
                          data["grad_mean"], occ, n_levels=DETECT_LEVELS, cell0=DETECT_CELL,
                          n_out=int(cfg.n_fts_max))
    f_det = cam.cam2world(det["px"]).to(f32)
    # the ring slot, batch and threshold go in as device scalars: init_seeds
    # would copy host numbers to the device, and such a copy waits for it
    seeds3 = init_seeds(seeds2, det, data["pyr"], f_det,
                        torch.full((), slot, dtype=i32, device=dev),
                        torch.full((), batch + 1, dtype=i32, device=dev), out["depth_mean"],
                        0.5 * torch.clamp_min(out["depth_min"], 1e-3),
                        torch.full((), cfg.seed_converge_sigma2_thresh, dtype=f32, device=dev),
                        n_levels=DETECT_LEVELS)

    st["kf_count"] = kf_idx + 1
    st["batch"] = batch + 1
    chk = (torch.sum(det["score"]) + ba["chi2_final"] + n_act.to(f32)).to(f32)
    n_seeds = torch.sum(seeds3["valid"].to(i32)) - torch.sum(seeds2["valid"].to(i32))
    stats = dict(chi2_init=ba["chi2_init"], chi2_final=ba["chi2_final"], activated=n_act,
                 seeds_initialised=n_seeds,
                 ba_points=torch.sum(pv_b.to(i32)), detected=torch.sum(det["valid"].to(i32)),
                 rows_b=rows_b, rows_act=rows)
    return st, seeds3, chk, stats

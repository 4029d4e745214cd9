"""The JAX package's evolving-map scan as a reference for the port's
``keyframe_work`` and ``run_scan`` (CPU, numpy in and out).

``bench.py`` builds its scan inside ``main()`` around a live
``FrameHandler``; its keyframe body cannot be imported.  This module copies
that code line for line (``bench.py`` lines cited at each block) and composes
it of ``hso_tpu`` functions, on a handler resumed from
``artifacts/bench_boot.npz`` as ``bench.py`` resumes it.  What differs from
``bench.py``, and only this: the counters are read where the bench reads them,
the ``lax.cond`` of the step is a Python ``if`` on the host's schedule (the
bench's ``kf_sched``), ``kf_work`` also returns the compaction rows
(``rows_b``) and the activation rows (``rows``), and the step is called frame
by frame instead of inside ``lax.scan``.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from hso_tpu.ba.local_ba import local_bundle_adjustment
from hso_tpu.cameras import PinholeCamera
from hso_tpu.config import Config
from hso_tpu.mapping.depth_filter import harvest_and_prune, init_seeds
from hso_tpu.math import se3, se3np
from hso_tpu.ops.detect import detect_features, occupancy_grid
from hso_tpu.pipeline.frame_handler import SEED_RING, FrameHandler
from hso_tpu.utils.checkpoint import load_checkpoint

KF_EVERY = 6                                 # bench.py:97


class JaxScan:
    """bench.py:274-541 on a handler resumed from ``boot_npz``."""

    def __init__(self, boot_npz: str):
        cam = PinholeCamera(640, 480, 400.0, 400.0, 320.0, 240.0)   # bench.py:110-111
        cfg = Config()
        vo = FrameHandler(cam, cfg)
        load_checkpoint(vo, boot_npz, resume_stage="default")       # bench.py:228-229
        self.cam, self.cfg, self.vo = cam, cfg, vo

        # bench.py:278-290 (the scan starts at the checkpoint's last keyframe)
        self.snap = vo._snapshot()
        self.step_fn = vo._fused_step()
        self.seeds0 = vo.seeds
        self.px_err_angle = vo.px_error_angle
        last = vo.last_frame
        self.obs0 = vo._prev_obs_dev(last)
        self.T0 = jnp.asarray(last.T_f_w, jnp.float32)
        self.pyr0 = last.data["pyr"]
        self.gm0 = jnp.float32(last.grad_mean)
        self.it0 = jnp.float32(last.intensity_mean)
        self.exp0 = jnp.float32(last.exposure)
        self.I_rel = jnp.asarray(se3np.identity(), jnp.float32)

        # bench.py:304-318
        self.R_RES = 512
        self.R_ACT = 64
        self.P0 = vo.points.p_max
        self.P_T = self.P0 + self.R_RES + 1
        self.TRASH = self.P_T - 1
        self.S_SEEDS = int(np.asarray(vo.seeds["valid"]).shape[0])
        self.kf0 = len(vo.kfs.frames)
        self.batch0 = vo.batch_counter
        self.TYPE_CAND_VALID = 8 + 2
        self.KW = int(cfg.n_kfs_window)
        self.N_FIX_GAUGE = 4
        self.P_BA = 2048
        self.MUT_KEYS = ("light", "pos_w", "pt_pack", "species")

    # bench.py:320-322
    def padP(self, a, fill=0.0):
        pad = [(0, self.P_T - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
        return jnp.pad(a, pad, constant_values=fill)

    # bench.py:326-344
    def _initial_obs_grid(self):
        vo, KW = self.vo, self.KW
        pack = np.zeros((self.P_T, KW, 7), np.float32)
        for kf in vo.kfs.frames[-KW:]:
            c = kf.kf_index % KW
            o = kf.obs
            sel = o["valid"] & (o["point_id"] >= 0)
            pid = o["point_id"][sel]
            f = o["f"][sel]
            pack[pid, c, 0:2] = f[:, :2] / np.maximum(f[:, 2:3], 1e-9)
            pack[pid, c, 2:4] = o["grad"][sel]
            pack[pid, c, 4] = o["species"][sel] == 1
            pack[pid, c, 5] = o["level"][sel]
            pack[pid, c, 6] = 1.0
        return pack

    # bench.py:346-363
    def make_state0(self, snap):
        vo, padP = self.vo, self.padP
        st = {k: padP(snap[k]) for k in self.MUT_KEYS}
        st["kf_poses"] = snap["kf_poses"]
        st["kf_exposure"] = snap["kf_exposure"]
        st["ring_T"] = snap["ring_T"]
        st["ring_exp"] = snap["ring_exp"]
        st["ring_kf"] = jnp.asarray(vo.seed_ring.astype(np.int32))
        st["kf_count"] = jnp.int32(self.kf0)
        st["batch"] = jnp.int32(self.batch0)
        st["cursor"] = jnp.int32(0)
        pts = vo.points
        st["f_host"] = padP(jnp.asarray(pts.host_f.astype(np.float32)))
        st["host_kf"] = padP(jnp.asarray(pts.host_kf.astype(np.int32)), fill=-1)
        st["idist"] = padP(jnp.asarray(pts.idist.astype(np.float32)))
        st["ba_pack"] = jnp.asarray(self._initial_obs_grid())
        return st

    def carry0(self):
        """bench.py:545-547."""
        acc0 = jnp.zeros((2, self.P_T), jnp.int32)
        st0 = self.make_state0(self.snap)
        return (self.T0, self.pyr0, self.gm0, self.it0, self.exp0, self.obs0, self.seeds0,
                acc0, st0)

    def frame_step(self, carry, img):
        """bench.py:365-373: the fused step on the carry."""
        (T_prev, prev_pyr, prev_gm, prev_it, exp_prev, obs, seeds, acc, st) = carry
        snap_t = {k: st[k] for k in self.MUT_KEYS + (
            "kf_poses", "kf_exposure", "ring_T", "ring_exp")}
        return self.step_fn(img, prev_pyr, prev_gm, T_prev, obs, prev_it, exp_prev,
                            self.I_rel, snap_t, seeds, jnp.float32(self.px_err_angle), acc)

    def kf_work(self, out, st, seeds):
        """bench.py:375-527; also returns ``rows_b`` and ``rows``."""
        cam, cfg = self.cam, self.cfg
        KW, P_T, TRASH, P_BA = self.KW, self.P_T, self.TRASH, self.P_BA
        N_FIX_GAUGE, R_ACT, R_RES, P0 = self.N_FIX_GAUGE, self.R_ACT, self.R_RES, self.P0
        S_SEEDS, TYPE_CAND_VALID = self.S_SEEDS, self.TYPE_CAND_VALID
        data = out["data"]

        st = dict(st)
        kf_idx = st["kf_count"]
        slot = jnp.mod(st["batch"], SEED_RING)
        st["kf_poses"] = st["kf_poses"].at[kf_idx].set(out["T_new"])
        st["kf_exposure"] = st["kf_exposure"].at[kf_idx].set(out["exposure"])
        st["ring_T"] = st["ring_T"].at[slot].set(out["T_new"])
        st["ring_exp"] = st["ring_exp"].at[slot].set(out["exposure"])
        st["ring_kf"] = st["ring_kf"].at[slot].set(kf_idx)

        # bench.py:392-404
        col = jnp.mod(kf_idx, KW)
        ok_slot = out["success"] & out["inlier"]
        pid = jnp.where(ok_slot, out["cid"], TRASH)
        f_c = out["f_cur"]
        meas = f_c[:, :2] / jnp.maximum(f_c[:, 2:3], 1e-9)
        row = jnp.concatenate([
            meas, out["grad_cur"],
            (out["species"] == 1).astype(jnp.float32)[:, None],
            out["level"].astype(jnp.float32)[:, None],
            ok_slot.astype(jnp.float32)[:, None]], axis=1)
        st["ba_pack"] = (st["ba_pack"].at[:, col].set(0.0)
                         .at[pid, col].set(row)
                         .at[TRASH].set(0.0))
        # bench.py:409-445
        base = kf_idx + 1 - KW
        g_col = base + jnp.mod(jnp.arange(KW) - base, KW)
        col_live = g_col >= 0
        T_win = st["kf_poses"][jnp.clip(g_col, 0, None)]
        free = col_live & (g_col != 0) & (g_col >= base + N_FIX_GAUGE)
        pt_valid = st["light"] >= 8
        host_in = (st["host_kf"] >= jnp.maximum(base, 0)) & (
            st["host_kf"] <= kf_idx)
        host_slot = jnp.mod(jnp.clip(st["host_kf"], 0, None), KW)
        pvalid = pt_valid & host_in
        obs_valid = ((st["ba_pack"][..., 6] > 0.5) & col_live[None, :]
                     & pvalid[:, None]
                     & (jnp.arange(KW)[None, :] != host_slot[:, None]))
        has_obs = jnp.any((st["ba_pack"][..., 6] > 0.5)
                          & col_live[None, :], axis=1)
        cand_b = pvalid & has_obs
        _, rows_b = jax.lax.top_k(
            jnp.where(cand_b, P_T - jnp.arange(P_T), 0), P_BA)
        pv_b = cand_b[rows_b]
        pk_b = st["ba_pack"][rows_b]
        obs_b = {"meas": pk_b[..., 0:2],
                 "grad": pk_b[..., 2:4],
                 "is_edgelet": pk_b[..., 4] > 0.5,
                 "level": pk_b[..., 5].astype(jnp.int32),
                 "valid": obs_valid[rows_b],
                 "f_host": st["f_host"][rows_b],
                 "host": host_slot[rows_b]}
        ba = local_bundle_adjustment(
            T_win, free, st["idist"][rows_b], pv_b, obs_b, n_kf=KW,
            n_pts=P_BA, n_iter=int(cfg.loba_num_iter),
            focal=float(cam.focal_mean))
        # bench.py:448-464
        st["kf_poses"] = st["kf_poses"].at[jnp.clip(g_col, 0, None)].set(
            jnp.where((col_live & free)[:, None, None], ba["T_kf"], T_win))
        id_ok_b = pv_b & (ba["idist"] > 1e-10)
        tgt_b = jnp.where(id_ok_b, rows_b, TRASH)
        st["idist"] = st["idist"].at[tgt_b].set(
            jnp.where(id_ok_b, ba["idist"], st["idist"][rows_b]))
        keep_b = (pk_b[..., 6] > 0.5) & (ba["obs_inlier"] | ~obs_b["valid"])
        st["ba_pack"] = st["ba_pack"].at[tgt_b, :, 6].set(
            keep_b.astype(jnp.float32)).at[TRASH].set(0.0)
        id_ok = jnp.zeros((P_T,), bool).at[tgt_b].set(id_ok_b)
        id_ok = id_ok.at[TRASH].set(False)
        T_h = st["kf_poses"][jnp.clip(st["host_kf"], 0, None)]
        pos_ba = se3.apply(
            se3.inv(T_h),
            st["f_host"] / jnp.maximum(st["idist"], 1e-9)[:, None])
        st["pos_w"] = jnp.where(id_ok[:, None],
                                pos_ba.astype(jnp.float32), st["pos_w"])

        # bench.py:467-509
        seeds_w = seeds
        seeds2, bundle = harvest_and_prune(
            seeds, st["batch"], st["ring_T"], cfg.max_seed_kf_batches,
            4.0, float(cam.focal_mean))
        conv = bundle[:, 0] > 0.5
        _, rows = jax.lax.top_k(
            jnp.where(conv, S_SEEDS - jnp.arange(S_SEEDS), 0), R_ACT)
        taken = conv[rows]
        b_r = bundle[rows]
        host_slot = b_r[:, 2].astype(jnp.int32)
        mu = jnp.maximum(b_r[:, 12], 1e-9)
        f_s = b_r[:, 5:8]
        T_h = st["ring_T"][host_slot]
        pos_new = se3.apply(se3.inv(T_h), f_s / mu[:, None])
        off = jnp.cumsum(taken.astype(jnp.int32)) - 1
        tgt = jnp.where(taken,
                        P0 + jnp.mod(st["cursor"] + off, R_RES), TRASH)
        st["pos_w"] = st["pos_w"].at[tgt].set(pos_new.astype(jnp.float32))
        st["light"] = st["light"].at[tgt].set(TYPE_CAND_VALID)
        st["f_host"] = st["f_host"].at[tgt].set(f_s.astype(jnp.float32))
        st["host_kf"] = st["host_kf"].at[tgt].set(
            jnp.where(taken, st["ring_kf"][host_slot], -1))
        st["idist"] = st["idist"].at[tgt].set(mu.astype(jnp.float32))
        hw = seeds_w["host_win"].shape[-1]
        c0 = (hw - 24) // 2
        new_rows = jnp.concatenate([
            seeds_w["host_win"][rows, c0:c0 + 24, c0:c0 + 24]
            .reshape(R_ACT, -1),
            b_r[:, 3:5],
            f_s,
            (seeds_w["host_anchor"][rows] + c0).astype(jnp.float32),
            b_r[:, 8:9],
            b_r[:, 10:12],
            b_r[:, 9:10],
            st["ring_kf"][host_slot][:, None].astype(jnp.float32),
        ], axis=1)
        st["pt_pack"] = st["pt_pack"].at[tgt].set(new_rows)
        st["species"] = st["species"].at[tgt].set(
            b_r[:, 9].astype(st["species"].dtype))
        st["cursor"] = jnp.mod(
            st["cursor"] + jnp.sum(taken.astype(jnp.int32)), R_RES)

        # bench.py:512-527
        occ = occupancy_grid(out["px"], out["inlier"],
                             cam.height, cam.width, 32)
        det = detect_features(data["pyr"][:3], data["sobel_x"],
                              data["sobel_y"], data["grad_mean"], occ,
                              n_out=cfg.n_fts_max)
        f_det = cam.cam2world(det["px"]).astype(jnp.float32)
        seeds3 = init_seeds(
            seeds2, det, data["pyr"], f_det, slot, st["batch"] + 1,
            out["depth_mean"], 0.5 * jnp.maximum(out["depth_min"], 1e-3),
            cfg.seed_converge_sigma2_thresh)

        st["kf_count"] = kf_idx + 1
        st["batch"] = st["batch"] + 1
        chk = (jnp.sum(det["score"]) + ba["chi2_final"]
               + jnp.sum(taken.astype(jnp.float32))).astype(jnp.float32)
        return st, seeds3, chk, dict(rows_b=rows_b, rows=rows, ba=ba, det=det)

    def step(self, carry, img, is_kf):
        """bench.py:365-541 with the ``lax.cond`` as a Python ``if``."""
        out = self.frame_step(carry, img)
        data = out["data"]
        st = carry[8]
        if is_kf:
            st, seeds_new, kf_chk, _ = self.kf_work(out, st, out["seeds"])
        else:
            seeds_new, kf_chk = out["seeds"], jnp.float32(0.0)
        chk = (kf_chk + out["n_seeds_updated"].astype(jnp.float32)
               + out["n_matches"].astype(jnp.float32) + out["err_px"])
        carry = (out["T_new"], data["pyr"], data["grad_mean"],
                 data["intensity_mean"], out["exposure"], out["obs_next"],
                 seeds_new, out["acc"], st)
        return carry, (out["T_new"], chk), out

    def run(self, imgs):
        """The scan over ``imgs`` from the start state (bench.py:543-553 without
        the jit): returns the trajectory (N, 3, 4), the per-frame chk and the
        per-frame step outputs (numpy)."""
        carry = self.carry0()
        traj, chks, outs = [], [], []
        for i, img in enumerate(imgs):
            carry, (T, chk), out = self.step(carry, jnp.asarray(img),
                                             i % KF_EVERY == KF_EVERY - 1)
            traj.append(np.asarray(T))
            chks.append(float(chk))
            outs.append(jax.tree.map(np.asarray, {k: out[k] for k in (
                "T_new", "n_inliers", "cid", "inlier", "success")}))
        return np.stack(traj), np.array(chks), outs, carry

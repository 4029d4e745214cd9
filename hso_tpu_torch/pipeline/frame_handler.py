"""The per-frame pipeline state machine: ``FrameHandler.add_image``.

Thin host orchestration over the device step and kernels, one synchronous
sequence a frame.  Stages: FIRST_FRAME → SECOND_FRAME → DEFAULT_FRAME ⇄
RELOCALIZING.  The DEFAULT path of a frame:

  the whole per-frame step (:func:`hso_tpu_torch.pipeline.fused_step.
  make_frame_step`: pyramid, coarse track against the last frame, grid
  selection and batched matching, motion-only pose LM, the depth-filter
  sweep) → tracking-quality gate → keyframe criterion → [keyframe: seed
  harvest, detection and the new seed batch, pre-frame backfill,
  covisibility window and Schur BA, seed activation] → motion model update.

Beyond the default path: TEMPORARY points from unconverged seeds on sparse
frames (the seed rescue, then a pose refinement over the whole observation
set), per-point patch-source refresh at keyframes, essential-matrix vs
homography bootstrap, relocalization against the closest keyframe (coarse
tracker) and by the map (memoized windows), and ``reset_all``.

Host syncs on the card.  A frame without a keyframe event waits on the
device twice: the step's FC/IC choice and the one copy of the 24-float
``packed`` vector.  A sparse frame adds the copy of the per-slot results.
Host data goes to the device as non-blocking copies from pinned memory, and
device scalars are made on the device, so neither waits.  A keyframe event
starts its copies back (``kf_pack``, the seed harvest, the patch-source
windows) as non-blocking copies into pinned memory right after the kernels
that make them, and reads them after the host work that does not need them.

The step and the relocalization tracker are built once per handler.
``cfg.photometric_calib`` and ``cfg.distributed_ba`` are not ported and
raise ``NotImplementedError``.

Point success/fail counters accumulate on the device (``acc``, integer
additions) and are drained into the host table at keyframe events.  A row
that the point table hands out starts with its counters at 0, whichever path
(bootstrap, seed rescue, seed activation) takes it, on the host and, for the
seed rescue (which runs between drains), on the device.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from hso_tpu_torch.config import Config
from hso_tpu_torch.image.pyramid import build_frame_pyramids
from hso_tpu_torch.mapmodel.structures import (
    TYPE_CANDIDATE,
    TYPE_GOOD,
    TYPE_TEMPORARY,
    TYPE_UNKNOWN,
    Frame,
    KeyframeWindow,
    PointTable,
    crop_window,
    empty_obs,
)
from hso_tpu_torch.mapping.depth_filter import (
    empty_seeds,
    gather_seed_windows,
    harvest_and_prune,
    init_seeds,
    update_seeds,
)
from hso_tpu_torch.math import se3np
from hso_tpu_torch.math.epipolar_geometry import recover_pose_twoview, triangulate_midpoint
from hso_tpu_torch.ops.detect import detect_features, occupancy_grid
from hso_tpu_torch.ops.gatherless import clip_anchor, extract_windows
from hso_tpu_torch.ops.klt import track_klt
from hso_tpu_torch.ops.warp import memoize_level_windows_packed
from hso_tpu_torch.pipeline import ba_glue
from hso_tpu_torch.pipeline.fused_step import make_frame_step, pack_light, scatter_rows
from hso_tpu_torch.track.coarse_tracker import make_coarse_tracker
from hso_tpu_torch.track.matcher import match_points, select_candidates
from hso_tpu_torch.track.pose_optimizer import optimize_pose

STAGE_FIRST = "first"
STAGE_SECOND = "second"
STAGE_DEFAULT = "default"
STAGE_RELOC = "relocalizing"

RESULT_KEYFRAME = "keyframe"
RESULT_FRAME = "frame"
RESULT_FAILURE = "failure"
RESULT_NO_KEYFRAME = "no_keyframe"

SEED_RING = 8
SEED_FETCH = ("valid", "host", "px", "f", "level", "species", "grad", "mu", "host_win",
              "host_anchor", "temp_point")


@dataclasses.dataclass
class FrameResult:
    status: str
    T_f_w: np.ndarray
    n_matches: int = 0
    n_inliers: int = 0
    n_seeds_updated: int = 0
    err_px: float = 0.0


def _fetch(*tensors) -> list:
    """Device tensors as numpy arrays through ONE device→host copy (flattened
    to float32: every value here is exact in float32)."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors]).cpu().numpy()
    out, off = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[off:off + n].reshape(tuple(t.shape)))
        off += n
    return out


class _Pending:
    """A device→host copy in flight: non-blocking into pinned memory on the
    card (an event marks its end), a plain copy on the CPU."""

    def __init__(self, t: torch.Tensor):
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t.clone()
            self.event = None

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class FrameHandler:
    def __init__(self, cam, cfg: Config | None = None, device="cuda"):
        self.cam = cam
        self.cfg = cfg or Config()
        if self.cfg.photometric_calib:
            raise NotImplementedError("online photometric calibration is not ported")
        if self.cfg.distributed_ba:
            raise NotImplementedError("distributed BA is not ported")
        self.device = torch.device(device)
        self.points = PointTable(self.cfg.n_points_ba_max * 2)
        self.kfs = KeyframeWindow(k_all_max=self.cfg.max_n_kfs, recent=SEED_RING)
        self.points.kfs = self.kfs
        self.seeds = empty_seeds(self.cfg.n_seeds_max, self.device)
        self.seed_ring = np.full(SEED_RING, -1, np.int32)  # ring slot → kf idx
        self.batch_counter = 0
        self.stage = STAGE_FIRST
        self.motion_model = se3np.identity()
        self.last_frame: Frame | None = None
        self.first_frame: Frame | None = None
        self.frame_count = 0
        self.regular_counter = 0
        self.n_last_inliers = 0
        self.after_init = False
        self.tracking_bad = False
        self.reloc_fail_count = 0
        self.mean_converge_frames = 6.0
        self.px_error_angle = float(np.arctan(1.0 / (2.0 * cam.focal_mean)) * 2.0)
        self.trajectory: list[tuple[float, np.ndarray]] = []
        # the candidate grid: every candidate cell is matched in one batched
        # call, so the cell count must fit the n_fts_max slot padding
        cell = max(int(np.sqrt(cam.width * cam.height / self.cfg.max_fts) * 0.8), 16)
        self._grid = (cell, -(-cam.height // cell), -(-cam.width // cell))
        # the step writes up to C kept matches into the frame's obs slots
        self._n_obs_pad = max(self.cfg.n_fts_max, self._grid[1] * self._grid[2])
        self._occ_cell = 32
        self._init_px = None
        # retained recent frames for the pre-frame seed backfill
        self.pre_frames: collections.deque = collections.deque(
            maxlen=self.cfg.pre_frames_max)
        # snapshot cache (see _snapshot): heavy uploads only when a keyframe
        # event or a seed rescue bumps the map version
        self._map_version = 0
        self._snap_heavy = None
        self._snap_heavy_version = -1
        self._snap_light = None
        self._snap_light_version = -1
        # device point success/fail counters (2, p_max), drained at keyframe
        # events (_apply_lifecycle)
        self._acc = None
        self._px_err_dev = None
        # rows whose patch/species data changed since the last heavy snapshot
        # upload; every writer of PointTable.patch_*/species marks its rows
        self._dirty_rows: set[int] = set()
        self._last_seed_match_px = None
        self._last_seed_matched = None
        self._step = None
        self._reloc_tracker = None

    # ------------------------------------------------------------------ utils
    def _h2d(self, a, dtype=None) -> torch.Tensor:
        """Host array → tensor on the handler's device.  On the card a
        non-blocking copy from pinned memory (the host never waits); the
        source is copied first, so later writes to it do not reach the
        tensor."""
        t = torch.from_numpy(np.array(a, copy=True))
        if dtype is not None:
            t = t.to(dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _scalar(self, x, dtype=torch.float32) -> torch.Tensor:
        """A device scalar made on the device (no copy from the host)."""
        return torch.full((), x, dtype=dtype, device=self.device)

    def _upload_image(self, img) -> torch.Tensor:
        if isinstance(img, torch.Tensor):
            return img.to(self.device)
        return self._h2d(img)

    def _make_frame(self, img_u8, ts: float) -> Frame:
        data = build_frame_pyramids(self._upload_image(img_u8), device=self.device)
        f = Frame(
            frame_id=self.frame_count,
            timestamp=ts,
            T_f_w=se3np.identity(),
            data=data,
            obs=empty_obs(self._n_obs_pad),
        )
        f.grad_mean, f.intensity_mean = (float(x) for x in _fetch(
            data["grad_mean"], data["intensity_mean"]))
        return f

    def _detect(self, frame: Frame, occupied_px: np.ndarray | None,
                n_levels: int = 3, cell0: int = 32):
        h, w = self.cam.height, self.cam.width
        cy, cx = -(-h // cell0), -(-w // cell0)
        if occupied_px is None or len(occupied_px) == 0:
            occ = torch.zeros((cy, cx), dtype=torch.bool, device=self.device)
        else:
            px = self._h2d(occupied_px, torch.float32)
            occ = occupancy_grid(px, torch.ones((len(occupied_px),), dtype=torch.bool,
                                                device=self.device), h, w, cell0)
        d = frame.data
        return detect_features(
            d["pyr"][:3], d["sobel_x"], d["sobel_y"], d["grad_mean"], occ,
            n_levels=n_levels, cell0=cell0, n_out=self.cfg.n_fts_max,
            with_gradient=bool(self.cfg.use_gradient_features),
        )

    # ------------------------------------------------------------------ stages
    def add_image(self, img_u8, ts: float = 0.0) -> FrameResult:
        if self.stage == STAGE_DEFAULT:
            # the pyramid is built inside the step
            frame = Frame(
                frame_id=self.frame_count, timestamp=ts,
                T_f_w=se3np.identity(), data=None,
                obs=empty_obs(self._n_obs_pad),
            )
            res = self._process_default(frame, img_u8)
        else:
            frame = self._make_frame(img_u8, ts)
            if self.stage == STAGE_FIRST:
                res = self._process_first(frame)
            elif self.stage == STAGE_SECOND:
                res = self._process_second(frame)
            else:
                res = self._relocalize(frame)
        self.last_frame = frame
        self.frame_count += 1
        self.trajectory.append((ts, frame.T_f_w.copy()))
        return res

    def _process_first(self, frame: Frame) -> FrameResult:
        det = self._detect(frame, None, n_levels=1, cell0=16)
        px, valid = _fetch(det["px"], det["valid"])
        valid = valid > 0.5
        if int(valid.sum()) < 100:
            return FrameResult(RESULT_NO_KEYFRAME, frame.T_f_w)
        frame.exposure = 1.0
        self.first_frame = frame
        self._init_px = px[valid]
        self._init_px_prior = self._init_px.copy()
        self.stage = STAGE_SECOND
        return FrameResult(RESULT_KEYFRAME, frame.T_f_w)

    def _process_second(self, frame: Frame) -> FrameResult:
        cfg = self.cfg
        px_ref = self._init_px
        n = len(px_ref)
        tr = track_klt(
            self.first_frame.data["pyr"], frame.data["pyr"],
            self._h2d(px_ref, torch.float32),
            torch.ones((n,), dtype=torch.bool, device=self.device),
            px_prior=self._h2d(self._init_px_prior, torch.float32),
        )
        ok, px_cur = _fetch(tr["ok"], tr["px_cur"])
        ok = ok > 0.5
        # incremental prior for the next attempt
        self._init_px_prior = np.where(ok[:, None], px_cur, self._init_px_prior)
        if ok.sum() < cfg.init_min_tracked:
            self._restart()
            return FrameResult(RESULT_FAILURE, frame.T_f_w)
        disp = np.linalg.norm(px_cur[ok] - px_ref[ok], axis=-1)
        if np.median(disp) < cfg.init_min_disparity:
            return FrameResult(RESULT_NO_KEYFRAME, frame.T_f_w)

        f1 = self.cam.cam2world(px_ref[ok])
        f2 = self.cam.cam2world(px_cur[ok])
        rec = recover_pose_twoview(f1, f2, self.cam.focal_mean)
        if rec is None or rec["n_inliers"] < cfg.init_min_inliers:
            self._restart()
            return FrameResult(RESULT_FAILURE, frame.T_f_w)

        inl = rec["inliers"]
        T_21 = rec["T_21"]
        p1, z1 = triangulate_midpoint(T_21, f1[inl], f2[inl])
        good = z1 > 1e-6
        depth_med = np.median(np.asarray(se3np.apply(T_21, p1[good]))[:, 2])
        scale = cfg.map_scale / max(depth_med, 1e-9)
        T_21s = T_21.copy()
        T_21s[..., :3, 3] *= scale
        p1 = p1 * scale

        # register keyframes
        self.first_frame.T_f_w = se3np.identity()
        self.first_frame.exposure = 1.0
        kf0 = self.kfs.add(self.first_frame)
        frame.T_f_w = T_21s
        frame.exposure = 1.0
        kf1 = self.kfs.add(frame)

        # points hosted in keyframe 0 (level-0 bootstrap features)
        px_ok = px_ref[ok][inl][good]
        px_cur_ok = px_cur[ok][inl][good]
        f1g = f1[inl][good]
        f2g = f2[inl][good]
        dist1 = np.linalg.norm(p1[good], axis=-1)
        idx = self.points.alloc(len(px_ok))
        m = len(idx)
        self.points.valid[idx] = True
        self.points.type[idx] = TYPE_UNKNOWN
        self.points.host_kf[idx] = kf0
        self.points.host_px[idx] = px_ok[:m]
        self.points.host_f[idx] = f1g[:m]
        self.points.host_level[idx] = 0
        self.points.species[idx] = 0
        self.points.idist[idx] = 1.0 / np.maximum(dist1[:m], 1e-9)
        # host windows (K1 at win 24 on level 0)
        img0 = self.first_frame.data["pyr"][0]
        px_dev = self._h2d(px_ok[:m], torch.float32)
        au, av = clip_anchor(px_dev[:, 0], px_dev[:, 1], 24, 0, *img0.shape)
        wins, au_np, av_np = _fetch(extract_windows(img0, au, av, 24), au, av)
        self.points.host_win[idx] = wins
        self.points.host_anchor[idx] = np.stack([au_np, av_np], axis=-1).astype(np.int32)
        self.points.init_patch_from_host(idx)
        self._mark_dirty(idx)

        # observations in both keyframes
        for kf_frame, px_obs, f_obs in (
            (self.first_frame, px_ok[:m], f1g[:m]),
            (frame, px_cur_ok[:m], f2g[:m]),
        ):
            o = kf_frame.obs
            o["valid"][:m] = True
            o["px"][:m] = px_obs
            o["f"][:m] = f_obs
            o["level"][:m] = 0
            o["species"][:m] = 0
            o["point_id"][:m] = idx
        self.points.last_obs_kf[idx] = kf1
        for kf_frame in (self.first_frame, frame):
            self.points.register_obs(kf_frame)

        # seed the depth filter from the second keyframe; the first keyframe
        # is a pre-frame, so new seeds get a wide-baseline backfill at once
        self.pre_frames.append(self.first_frame)
        self._add_keyframe_seeds(frame, depth_mean=cfg.map_scale,
                                 depth_min=float(dist1.min() * 0.5),
                                 converge_thresh=cfg.seed_converge_sigma2_thresh)
        self.stage = STAGE_DEFAULT
        self.n_last_inliers = m
        self.regular_counter = 0
        self.after_init = True
        self._bump_map_version()
        return FrameResult(RESULT_KEYFRAME, frame.T_f_w, n_matches=m, n_inliers=m)

    # ------------------------------------------------------------------ default
    def _process_default(self, frame: Frame, img=None) -> FrameResult:
        """The default per-frame path: one call of the whole step, then host
        bookkeeping."""
        out = self._dispatch_default(
            frame, img, self.seeds, self._h2d(self.motion_model, torch.float32))
        return self._finalize_default(frame, out, self.last_frame.T_f_w)

    def _dispatch_default(self, frame: Frame, img, seeds_in, I_rel):
        """Enqueue the whole step and attach its device outputs to ``frame``."""
        last = self.last_frame
        img_dev = frame.data["pyr"][0] if img is None else self._upload_image(img)
        step = self._fused_step()
        snap = self._snapshot()
        prev_obs = self._prev_obs_dev(last)
        T_prev = getattr(last, "T_dev", None)
        if T_prev is None:
            T_prev = self._h2d(last.T_f_w, torch.float32)
        prev_gm = getattr(last, "grad_mean_dev", None)
        if prev_gm is None:
            prev_gm = self._scalar(last.grad_mean)
        prev_it = getattr(last, "intensity_dev", None)
        if prev_it is None:
            prev_it = self._scalar(last.intensity_mean)
        exp_prev = getattr(last, "exp_dev", None)
        if exp_prev is None:
            exp_prev = self._scalar(last.exposure)
        if self._acc is None:
            self._acc = torch.zeros((2, self.points.p_max), dtype=torch.int32,
                                    device=self.device)

        out = step(img_dev, last.data["pyr"], prev_gm, T_prev, prev_obs, prev_it, exp_prev,
                   I_rel, snap, seeds_in, self._px_error_dev(), self._acc)

        self._acc = out["acc"]
        frame.data = out["data"]
        frame.grad_mean_dev = out["data"]["grad_mean"]
        frame.intensity_dev = out["data"]["intensity_mean"]
        frame.T_dev = out["T_new"]
        frame.obs_dev = out["obs_next"]
        frame.exp_dev = out["exposure"]
        return out

    def _finalize_default(self, frame: Frame, out, prev_T_host) -> FrameResult:
        """Consume the step's results: the one ``packed`` copy, the quality
        gate, the sparse-frame seed rescue, the keyframe event and the host
        bookkeeping."""
        cfg = self.cfg
        packed = out["packed"].cpu().numpy().astype(np.float64)

        frame.T_f_w = se3np.normalize(packed[:12].reshape(3, 4))
        frame.exposure = float(packed[12])
        frame.grad_mean = float(packed[22])
        frame.intensity_mean = float(packed[23])

        n_matches = int(packed[13])
        n_inliers = int(packed[14])
        err_px = float(packed[15])

        synced = False
        if n_matches < 100:
            self._writeback_obs(frame, out)
            synced = True
            # sparse frame: also match unconverged seeds as TEMPORARY points,
            # then refine the pose over the combined observation set; the
            # rescue runs before the quality gate, which it exists to pass
            n_temp = self._reproject_seeds(frame, n_matches)
            if n_temp:
                n_matches += n_temp
                n_inliers, err_px = self._pose_refine_host(frame)
                frame.T_dev = None
                frame.obs_dev = None

        if n_matches < cfg.quality_min_fts or n_inliers < cfg.quality_min_fts:
            frame.T_f_w = np.asarray(prev_T_host).copy()
            self.stage = STAGE_RELOC
            return FrameResult(RESULT_FAILURE, frame.T_f_w, n_matches, n_inliers)
        self.tracking_bad = (
            min(self.n_last_inliers, cfg.max_fts) - n_inliers
            > cfg.quality_max_drop_fts
        )
        self.n_last_inliers = n_inliers

        depth_mean = float(packed[16]) if np.isfinite(packed[16]) else 1.0
        depth_min = float(packed[17]) if np.isfinite(packed[17]) else 0.1
        distance_mean = float(packed[18]) if np.isfinite(packed[18]) else 1.0

        # the sweep's seeds are taken only on frames that did not fail
        self.seeds = out["seeds"]
        n_upd = int(packed[19])

        # ---- keyframe decision (the frame right after the bootstrap is one)
        is_kf = self.after_init or self._need_new_kf(frame, distance_mean)
        self.after_init = False
        result = RESULT_FRAME
        if is_kf:
            result = RESULT_KEYFRAME
            self.regular_counter = 0
            # sparse frames get a laxer convergence bar
            base_th = cfg.seed_converge_sigma2_thresh
            thresh = base_th / 2.0 if n_inliers <= 70 else base_th
            # enqueue all keyframe device work before any host read
            kf_dev = self._kf_map_dispatch(
                frame, out, distance_mean, 0.5 * max(depth_min, 1e-3), thresh)
            self._kf_sync(frame, out, already_synced=synced, kp=kf_dev["kf_pack"])
            kf_idx = self.kfs.add(frame)
            # CANDIDATE points observed here become UNKNOWN
            o = frame.obs
            seen = o["point_id"][o["valid"]]
            cand = seen[self.points.type[seen] == TYPE_CANDIDATE]
            self.points.type[cand] = TYPE_UNKNOWN
            # observed points re-memoize their appearance from this view
            self._refresh_patch_sources(
                frame, buf=kf_dev["refresh_buf"],
                slot_rows=getattr(frame, "_slot_rows", None))
            self.points.register_obs(frame)
            # release points that left the field of view
            self.points.gc_stale(kf_idx)
            self._run_ba(frame)
            self._kf_map_finish(kf_dev)
            self._bump_map_version()
        else:
            self.regular_counter += 1

        self.motion_model = se3np.mul(
            frame.T_f_w, se3np.inv(np.asarray(prev_T_host, np.float64)))
        self.pre_frames.append(frame)
        return FrameResult(result, frame.T_f_w, n_matches, n_inliers, n_upd, err_px)

    def _kf_sync(self, frame: Frame, out, already_synced: bool, kp=None) -> None:
        """Read the step's ``kf_pack`` (per-slot match results, the lifecycle
        counters and the seed match statistics) in one copy."""
        C = self._grid[1] * self._grid[2]
        P = self.points.p_max
        S = int(self.seeds["valid"].shape[0])
        kp = kp.numpy() if kp is not None else out["kf_pack"].cpu().numpy()
        sp = kp[: C * 11].reshape(C, 11)
        acc = kp[C * 11: C * 11 + 2 * P].reshape(2, P).astype(np.int64)
        off = C * 11 + 2 * P
        self._last_seed_match_px = kp[off: off + 2 * S].reshape(S, 2)
        self._last_seed_matched = kp[off + 2 * S: off + 3 * S] > 0.5
        if not already_synced:
            self._writeback_obs(frame, out, sp=sp)
        self._apply_lifecycle(frame, acc=acc)

    def _writeback_obs(self, frame: Frame, out, sp=None) -> None:
        """Fill the frame's host observation table with the step's kept
        matches (one copy of ``slot_pack`` unless ``sp`` is given)."""
        if sp is None:
            sp = out["slot_pack"].cpu().numpy()
        flags = sp[:, 10].astype(np.int32)
        keep = (flags & 3) == 3          # success & inlier
        w = np.where(keep)[0]
        frame._slot_rows = w             # obs row i ↔ step slot w[i]
        o = frame.obs
        rows = slice(0, len(w))
        o["valid"][rows] = True
        o["px"][rows] = sp[w, 0:2]
        o["f"][rows] = sp[w, 2:5]
        o["level"][rows] = sp[w, 7].astype(np.int32)
        o["species"][rows] = sp[w, 8].astype(np.int32)
        o["grad"][rows] = sp[w, 5:7]
        o["point_id"][rows] = sp[w, 9].astype(np.int32)

    def _apply_lifecycle(self, frame: Frame | None = None, acc=None) -> None:
        """Drain the device success/fail counters into the host point table and
        apply the lifecycle rules: TEMPORARY dies after >3 failures, UNKNOWN
        after >15; UNKNOWN with >10 successes becomes GOOD."""
        if self._acc is None:
            return
        if acc is None:
            acc = self._acc.cpu().numpy().astype(np.int64)
        pts = self.points
        if acc.any():
            pts.n_succ += acc[0]
            pts.n_fail += acc[1]
            touched = acc[1] > 0
            kill = np.nonzero(touched & pts.valid & (
                ((pts.type == TYPE_TEMPORARY) & (pts.n_fail > 3))
                | ((pts.type == TYPE_UNKNOWN) & (pts.n_fail > 15))))[0]
            pts.release(kill)
            promote = np.nonzero((acc[0] > 0) & pts.valid
                                 & (pts.type == TYPE_UNKNOWN)
                                 & (pts.n_succ > 10))[0]
            pts.type[promote] = TYPE_GOOD
            self._acc = torch.zeros((2, pts.p_max), dtype=torch.int32, device=self.device)
            # scrub obs rows of the current frame that reference points the
            # drain just released (not yet in the inverted index)
            if frame is not None and frame.obs is not None:
                o = frame.obs
                pid = np.where(o["point_id"] >= 0, o["point_id"], 0)
                bad = o["valid"] & ~pts.valid[pid]
                o["valid"][bad] = False
                o["point_id"][bad] = -1

    def _fused_step(self):
        """The whole per-frame step, built once per handler."""
        if self._step is None:
            cfg = self.cfg
            self._step = make_frame_step(
                self.cam, self._grid, cfg.klt_max_level, cfg.klt_min_level,
                cfg.coarse_n_iter, cfg.coarse_pattern_offset,
                cfg.poseoptim_thresh, n_obs_pad=self._n_obs_pad,
                edgelet_cos_angle=cfg.edgelet_angle,
                align_max_iter=cfg.align_max_iter,
                patch_closest=(cfg.patch_source == "closest"), device=self.device)
        return self._step

    def _bump_map_version(self) -> None:
        self._map_version += 1

    def _mark_dirty(self, rows) -> None:
        """Record point rows whose patch/species data changed (written into the
        device snapshot at the next _snapshot)."""
        self._dirty_rows.update(np.atleast_1d(np.asarray(rows, np.int64)).tolist())

    def _pt_pack_rows(self, idx, host: bool = False) -> np.ndarray:
        """Packed per-point patch-source rows (layout: ``fused_step.PT_COLS``)."""
        pts = self.points
        if host:
            win, px, f = pts.host_win, pts.host_px, pts.host_f
            anc, lvl, grad, kf = (pts.host_anchor, pts.host_level, pts.grad,
                                  pts.host_kf)
        else:
            win, px, f = pts.patch_win, pts.patch_px, pts.patch_f
            anc, lvl, grad, kf = (pts.patch_anchor, pts.patch_level,
                                  pts.patch_grad, pts.patch_kf)
        return np.concatenate([
            win[idx].reshape(len(idx), -1), px[idx], f[idx],
            anc[idx], lvl[idx, None], grad[idx],
            pts.species[idx, None], kf[idx, None],
        ], axis=1).astype(np.float32)

    def _ring_exposures(self) -> np.ndarray:
        return np.array([self.kfs.exposure[i] if i >= 0 else 1.0 for i in self.seed_ring],
                        np.float32)

    def _snapshot(self) -> dict:
        """The step's map snapshot on the device.  Heavy members are refreshed
        only when the map version changed, and then incrementally: positions
        and keyframe poses whole, the packed per-point table by a row copy of
        the rows marked dirty since the last refresh."""
        pts = self.points
        closest = self.cfg.patch_source == "closest"
        f32 = torch.float32
        if self._snap_heavy is not None and self._snap_heavy_version != self._map_version:
            heavy = dict(self._snap_heavy)
            heavy["pos_w"] = self._h2d(pts.positions(self.kfs.poses), f32)
            heavy["kf_poses"] = self._h2d(self.kfs.poses, f32)
            heavy["kf_exposure"] = self._h2d(self.kfs.exposure)
            heavy["ring_T"] = self._h2d(self._ring_poses())
            heavy["ring_exp"] = self._h2d(self._ring_exposures())
            rows = np.fromiter(self._dirty_rows, np.int64, len(self._dirty_rows))
            rows.sort()
            if len(rows):
                idx_dev = self._h2d(rows)
                heavy["pt_pack"] = scatter_rows(heavy["pt_pack"], idx_dev,
                                                self._h2d(self._pt_pack_rows(rows)))
                heavy["species"] = scatter_rows(heavy["species"], idx_dev,
                                                self._h2d(pts.species[rows]))
                if closest:
                    heavy["host_pack"] = scatter_rows(
                        heavy["host_pack"], idx_dev,
                        self._h2d(self._pt_pack_rows(rows, host=True)))
            self._dirty_rows.clear()
            self._snap_heavy = heavy
            self._snap_heavy_version = self._map_version
        elif self._snap_heavy is None:
            all_rows = np.arange(pts.p_max)
            self._snap_heavy = {
                "pos_w": self._h2d(pts.positions(self.kfs.poses), f32),
                "kf_poses": self._h2d(self.kfs.poses, f32),
                "kf_exposure": self._h2d(self.kfs.exposure),
                "ring_T": self._h2d(self._ring_poses()),
                "ring_exp": self._h2d(self._ring_exposures()),
                "pt_pack": self._h2d(self._pt_pack_rows(all_rows)),
                "species": self._h2d(pts.species),
            }
            if closest:
                self._snap_heavy["host_pack"] = self._h2d(
                    self._pt_pack_rows(all_rows, host=True))
            self._dirty_rows.clear()
            self._snap_heavy_version = self._map_version
        if self._snap_light is None or self._snap_light_version != self._map_version:
            self._snap_light = self._h2d(pack_light(pts.type, pts.valid))
            self._snap_light_version = self._map_version
        snap = dict(self._snap_heavy)
        snap["light"] = self._snap_light
        return snap

    def _prev_obs_dev(self, last: Frame) -> dict:
        od = getattr(last, "obs_dev", None)
        if od is not None:
            return od
        o = last.obs
        ov = o["valid"] & (o["point_id"] >= 0)
        return {
            "px": self._h2d(o["px"], torch.float32),
            "f": self._h2d(o["f"], torch.float32),
            "pid": self._h2d(np.where(ov, o["point_id"], 0).astype(np.int32)),
            "valid": self._h2d(ov),
        }

    def _optimize_pose_host(self, frame: Frame, **kw) -> tuple:
        """Motion-only pose LM over the frame's observation table: returns
        (T_f_w float64, inlier mask, n_inliers, err_final_px) from one copy."""
        o = frame.obs
        ov = o["valid"] & (o["point_id"] >= 0)
        pid = np.where(ov, o["point_id"], 0)
        p_world = self.points.positions(self.kfs.poses)[pid].astype(np.float32)
        pout = optimize_pose(
            self._h2d(frame.T_f_w, torch.float32), self._h2d(p_world),
            self._h2d(o["f"], torch.float32), self._h2d(o["level"]),
            self._h2d(o["grad"], torch.float32), self._h2d(o["species"] == 1),
            self._h2d(self.points.type[pid] == TYPE_TEMPORARY), self._h2d(ov),
            focal=float(self.cam.focal_mean), **kw)
        T, inlier, n_inl, err = _fetch(pout["T_f_w"], pout["inlier"], pout["n_inliers"],
                                       pout["err_final_px"])
        return (se3np.normalize(T.astype(np.float64)), ov, inlier > 0.5, int(n_inl),
                float(err))

    def _pose_refine_host(self, frame: Frame) -> tuple[int, float]:
        """Pose LM over the frame's full observation table (after the seed
        rescue changed the observation set); strips the outliers."""
        o = frame.obs
        T, ov, inlier, _, err = self._optimize_pose_host(
            frame, reproj_thresh=self.cfg.poseoptim_thresh)
        frame.T_f_w = T
        o["point_id"] = np.where(ov & ~inlier, -1, o["point_id"])
        o["valid"] &= o["point_id"] >= 0
        return int(inlier.sum()), err

    # ------------------------------------------------------------------ blocks
    def _match_rows(self, frame: Frame, cand: dict, n_live: int) -> dict:
        """``match_points`` on host candidate rows padded to n_fts_max; the
        results come back in one copy."""
        n_max = self.cfg.n_fts_max
        cand_dev = {k: self._h2d(v) for k, v in cand.items()}
        cand_dev["valid"] = torch.arange(n_max, device=self.device) < n_live
        d = frame.data
        mout = match_points(
            cand_dev, d["pyr"], d["sobel_x"], d["sobel_y"],
            self._h2d(frame.T_f_w, torch.float32), frame.exposure, self.cam,
            edgelet_cos_angle=self.cfg.edgelet_angle,
            align_max_iter=self.cfg.align_max_iter,
        )
        success, px, level, f_cur, grad_cur = _fetch(
            mout["success"], mout["px"], mout["level"], mout["f_cur"], mout["grad_cur"])
        live = np.arange(n_max) < n_live
        return {"live": live, "success": (success > 0.5) & live, "px": px,
                "level": level.astype(np.int32), "f_cur": f_cur, "grad_cur": grad_cur}

    def _match_point_batch(self, frame: Frame, cand_idx: np.ndarray,
                           pos_w: np.ndarray) -> dict:
        """Batched direct matching of up to n_fts_max map points, warped from
        each point's patch-source view."""
        pts = self.points
        n_max = self.cfg.n_fts_max
        cand_idx = cand_idx[:n_max]
        pad = n_max - len(cand_idx)
        cidx = np.pad(cand_idx, (0, pad))
        pkf = pts.patch_kf[cidx]
        T_p = self.kfs.poses[pkf]
        p_in_patch = se3np.apply(T_p, pos_w[cidx].astype(np.float64))
        idist_p = (
            1.0 / np.maximum(np.linalg.norm(p_in_patch, axis=-1), 1e-9)
        ).astype(np.float32)
        cand = {
            "host_win": pts.patch_win[cidx],
            "host_anchor": pts.patch_anchor[cidx],
            "host_px": pts.patch_px[cidx],
            "host_f": pts.patch_f[cidx],
            "host_level": pts.patch_level[cidx],
            "grad": pts.patch_grad[cidx],
            "species": pts.species[cidx],
            "idist": idist_p,
            "T_host_w": T_p.astype(np.float32),
            "exposure_host": self.kfs.exposure[pkf],
        }
        res = self._match_rows(frame, cand, len(cand_idx))
        res["cidx"] = cidx
        return res

    def _reproject(self, frame: Frame) -> int:
        cell, gh, gw = self._grid
        pos_w = self.points.positions(self.kfs.poses).astype(np.float32)
        priority = self.points.type.astype(np.int32)
        sel = select_candidates(
            self._h2d(pos_w), self._h2d(self.points.valid), self._h2d(priority),
            self._h2d(frame.T_f_w, torch.float32), self.cam, cell=cell, grid_h=gh, grid_w=gw,
        )
        cell_valid, cell_point, cv2, cell_point2 = _fetch(
            sel["cell_valid"], sel["cell_point"], sel["cell_valid2"], sel["cell_point2"])
        cell_valid, cv2 = cell_valid > 0.5, cv2 > 0.5
        cell_point = cell_point.astype(np.int32)
        cell_point2 = cell_point2.astype(np.int32)
        cand_idx = cell_point[cell_valid]
        if len(cand_idx) == 0:
            return 0
        batches = [self._match_point_batch(frame, cand_idx, pos_w)]

        # pass 2: cells whose best candidate failed retry with their runner-up
        first_fail = ~batches[0]["success"][: len(cand_idx)]
        fail_cells = np.where(cell_valid)[0][first_fail[: len(cand_idx)]]
        retry_cells = fail_cells[cv2[fail_cells]]
        budget_left = self.cfg.max_fts - int(batches[0]["success"].sum())
        if len(retry_cells) and budget_left > 0:
            cand2 = cell_point2[retry_cells][:budget_left]
            batches.append(self._match_point_batch(frame, cand2, pos_w))

        pts = self.points
        o = frame.obs
        n_filled = 0
        for b in batches:
            success, live, cidx = b["success"], b["live"], b["cidx"]
            good_ids = cidx[success]
            fail_ids = cidx[~success & live]
            pts.n_succ[good_ids] += 1
            pts.n_fail[fail_ids] += 1
            kill = fail_ids[
                (pts.type[fail_ids] == TYPE_TEMPORARY) & (pts.n_fail[fail_ids] > 3)
            ]
            self.points.release(kill)
            kill2 = fail_ids[
                (pts.type[fail_ids] == TYPE_UNKNOWN) & (pts.n_fail[fail_ids] > 15)
            ]
            self.points.release(kill2)
            promote = good_ids[
                (pts.type[good_ids] == TYPE_UNKNOWN) & (pts.n_succ[good_ids] > 10)
            ]
            pts.type[promote] = TYPE_GOOD

            w = np.where(success)[0]
            n_m = len(w)
            if n_m == 0:
                continue
            rows = slice(n_filled, n_filled + n_m)
            o["valid"][rows] = True
            o["px"][rows] = b["px"][w]
            o["f"][rows] = b["f_cur"][w]
            o["level"][rows] = b["level"][w]
            o["species"][rows] = pts.species[cidx[w]]
            o["grad"][rows] = b["grad_cur"][w]
            o["point_id"][rows] = cidx[w]
            n_filled += n_m
        return n_filled

    def _reproject_seeds(self, frame: Frame, n_have: int) -> int:
        """Match unconverged seeds into the frame; successful matches become
        TEMPORARY map points (half-weighted in the pose LM)."""
        sd = {k: self.seeds[k].cpu().numpy() for k in SEED_FETCH}
        alive = sd["valid"] & (sd["temp_point"] < 0) & (sd["mu"] > 1e-10)
        if alive.sum() == 0:
            return 0
        host_kf = self.seed_ring[sd["host"]]
        T_h = self.kfs.poses[host_kf]
        # parallax gate: cos angle > 0.5
        p_w = se3np.apply(se3np.inv(T_h), (sd["f"] / np.maximum(sd["mu"], 1e-10)[:, None])
                          .astype(np.float64))
        host_pos = se3np.translation(se3np.inv(T_h))
        cur_pos = se3np.translation(se3np.inv(frame.T_f_w))
        d_ref = host_pos - p_w
        d_cur = cur_pos - p_w
        cosang = np.sum(d_ref * d_cur, -1) / np.maximum(
            np.linalg.norm(d_ref, axis=-1) * np.linalg.norm(d_cur, axis=-1), 1e-9
        )
        alive &= cosang > 0.5
        idxs = np.where(alive)[0]
        if len(idxs) == 0:
            return 0
        n_max = self.cfg.n_fts_max
        idxs = idxs[: n_max]
        cidx = np.pad(idxs, (0, n_max - len(idxs)))
        cand = {
            "host_win": sd["host_win"][cidx],
            "host_anchor": sd["host_anchor"][cidx],
            "host_px": sd["px"][cidx],
            "host_f": sd["f"][cidx],
            "host_level": sd["level"][cidx],
            "grad": sd["grad"][cidx],
            "species": sd["species"][cidx],
            "idist": sd["mu"][cidx],
            "T_host_w": T_h[cidx].astype(np.float32),
            "exposure_host": self.kfs.exposure[host_kf[cidx]],
        }
        mres = self._match_rows(frame, cand, len(idxs))
        wsel = np.where(mres["success"])[0]
        # budget to the frame feature target, not the slot capacity
        budget = max(0, min(len(wsel), self.cfg.max_fts - n_have))
        wsel = wsel[:budget]
        if len(wsel) == 0:
            return 0
        pidx = self._alloc_between_drains(len(wsel))
        m = len(pidx)
        wsel = wsel[:m]
        s_ids = cidx[wsel]
        pts = self.points
        pts.valid[pidx] = True
        pts.type[pidx] = TYPE_TEMPORARY
        pts.host_kf[pidx] = host_kf[s_ids]
        pts.host_px[pidx] = sd["px"][s_ids]
        pts.host_f[pidx] = sd["f"][s_ids]
        pts.host_level[pidx] = sd["level"][s_ids]
        pts.species[pidx] = sd["species"][s_ids]
        pts.grad[pidx] = sd["grad"][s_ids]
        pts.idist[pidx] = sd["mu"][s_ids]
        win_c, anch_c = crop_window(
            sd["host_win"][s_ids], sd["host_anchor"][s_ids],
            sd["px"][s_ids], sd["level"][s_ids],
        )
        pts.host_win[pidx] = win_c
        pts.host_anchor[pidx] = anch_c
        pts.last_obs_kf[pidx] = len(self.kfs.frames) - 1
        pts.init_patch_from_host(pidx)
        self._mark_dirty(pidx)
        # link seed → temporary point (a new table: the step's last output
        # may still hold the old one)
        self.seeds = dict(self.seeds)
        self.seeds["temp_point"] = self.seeds["temp_point"].index_put(
            (self._h2d(s_ids.astype(np.int64)),), self._h2d(pidx))
        # observations
        o = frame.obs
        free = np.where(~o["valid"])[0][: m]
        o["valid"][free] = True
        o["px"][free] = mres["px"][wsel]
        o["f"][free] = mres["f_cur"][wsel]
        o["level"][free] = mres["level"][wsel]
        o["species"][free] = sd["species"][s_ids]
        o["grad"][free] = mres["grad_cur"][wsel]
        o["point_id"][free] = pidx
        self._bump_map_version()          # new TEMPORARY landmarks
        return len(free)

    def _alloc_between_drains(self, n: int) -> np.ndarray:
        """``points.alloc`` for a path that runs between two drains of the
        device counters (the seed rescue): the rows' device counters restart
        at 0 too.  A row released without a drain (by ``_reproject`` on the
        relocalization path) may still hold device counts of the point that
        had it, which the next drain would add to the new point."""
        idx = self.points.alloc(n)
        if self._acc is not None and len(idx):
            self._acc = self._acc.index_fill(1, self._h2d(idx.astype(np.int64)), 0)
        return idx

    def _refresh_patch_sources(self, frame: Frame, buf=None, slot_rows=None) -> None:
        """Re-memoize the appearance window of every point observed in this
        keyframe from the new view.  ``buf``/``slot_rows``: the per-slot window
        buffer of :meth:`_kf_map_dispatch` (its copy started before the
        ``kf_pack`` read), valid only while the obs table is the pure slot
        write-back; else one window gather over the observed rows."""
        o = frame.obs
        sel = o["valid"] & (o["point_id"] >= 0)
        if not sel.any():
            return
        idxs = np.where(sel)[0]
        if buf is not None and slot_rows is not None and sel.sum() == len(slot_rows):
            b = buf.numpy()[slot_rows]
        else:
            b = memoize_level_windows_packed(
                frame.data["pyr"], self._h2d(o["px"][idxs], torch.float32),
                self._h2d(o["level"][idxs])).cpu().numpy()
        # the write-back fills obs rows 0..len(w) in ascending slot order, so
        # buf[slot_rows] is in obs-row order
        wins = b[:, :-2].reshape(-1, 24, 24)
        anchors = b[:, -2:].astype(np.int32)
        pid = o["point_id"][idxs]
        pts = self.points
        pts.patch_kf[pid] = frame.kf_index
        pts.patch_px[pid] = o["px"][idxs]
        pts.patch_f[pid] = o["f"][idxs]
        pts.patch_level[pid] = o["level"][idxs]
        pts.patch_grad[pid] = o["grad"][idxs]
        pts.patch_win[pid] = wins
        pts.patch_anchor[pid] = anchors
        self._mark_dirty(pid)

    def _need_new_kf(self, frame: Frame, distance_mean: float) -> bool:
        # at least 3 frames between keyframes
        if self.regular_counter < 3:
            return False
        last_kf = self.kfs.last()
        o = last_kf.obs
        ov = o["valid"] & (o["point_id"] >= 0)
        if ov.sum() < 5:
            return True
        pid = o["point_id"][ov]
        pos = self.points.positions(self.kfs.poses)[pid]
        p_ref = se3np.apply(last_kf.T_f_w, pos)
        dist = np.linalg.norm(p_ref, axis=-1)
        f = o["f"][ov].astype(np.float64)
        p_ref_ray = f * dist[:, None]

        T_full = se3np.mul(frame.T_f_w, se3np.inv(last_kf.T_f_w))
        T_nR = se3np.from_Rt(np.eye(3), se3np.translation(T_full))
        uv_full = self.cam.world2cam(se3np.apply(T_full, p_ref_ray))
        uv_nR = self.cam.world2cam(se3np.apply(T_nR, p_ref_ray))
        px_kf = o["px"][ov]
        flow_full = np.mean(np.sum((uv_full - px_kf) ** 2, axis=-1))
        if flow_full < 133.0:
            return False
        flow_full = np.sqrt(flow_full)
        flow_nR = np.sqrt(np.mean(np.sum((uv_nR - px_kf) ** 2, axis=-1)))

        default_res = 752 + 480
        max_shift_t = 0.04 * default_res
        max_shift_rt = 0.02 * default_res
        kf_weight = 0.75
        wh = self.cam.width + self.cam.height
        judgement = (
            kf_weight * max_shift_t * flow_nR / wh
            + kf_weight * max_shift_rt * flow_full / wh
        )
        return judgement > 1.0

    # ---------------------------------------------------------------- mapping
    def _ring_poses(self) -> np.ndarray:
        return np.stack(
            [
                self.kfs.poses[i] if i >= 0 else se3np.identity()
                for i in self.seed_ring
            ]
        ).astype(np.float32)

    def _kf_map_dispatch(self, frame: Frame, out, depth_mean, depth_min,
                         converge_thresh) -> dict:
        """Enqueue the keyframe's device work (patch-source windows, seed
        harvest, detection with the device-side occupancy, the new seed batch,
        the pre-frame backfill) with its copies back started, before any host
        read.  The host completes it in :meth:`_kf_map_finish` after the BA."""
        kf_pack = _Pending(out["kf_pack"])
        # per-slot patch-source windows (read by _refresh_patch_sources)
        refresh_buf = memoize_level_windows_packed(frame.data["pyr"], out["px"], out["level"])

        # seed harvest (activation threshold from the convergence-rate
        # statistic)
        seeds_before = self.seeds
        min_act = float(np.clip(0.7 * self.mean_converge_frames, 3.0, 8.0))
        self.seeds, bundle = harvest_and_prune(
            self.seeds, self.batch_counter, self._h2d(self._ring_poses()),
            self.cfg.max_seed_kf_batches, min_act, float(self.cam.focal_mean),
        )

        # detection with the device-side occupancy: the step's kept matches
        # and the matched seeds
        px_occ = torch.cat([out["px"], out["seed_match_px"]], dim=0)
        v_occ = torch.cat([out["success"] & out["inlier"], out["seed_matched"]], dim=0)
        occ = occupancy_grid(px_occ, v_occ, self.cam.height, self.cam.width, self._occ_cell)
        d = frame.data
        det = detect_features(
            d["pyr"][:3], d["sobel_x"], d["sobel_y"], d["grad_mean"], occ,
            n_out=self.cfg.n_fts_max,
            with_gradient=bool(self.cfg.use_gradient_features))
        f_det = self.cam.cam2world(det["px"]).to(torch.float32)

        # the new seed batch, hosted in this keyframe (its index is the one
        # kfs.add is about to give)
        kf_idx = len(self.kfs.frames)
        self.batch_counter += 1
        ring_slot = kf_idx % SEED_RING
        self.seed_ring[ring_slot] = kf_idx
        self.seeds = init_seeds(
            self.seeds, det, frame.data["pyr"], f_det,
            self._scalar(ring_slot, torch.int32), self._scalar(self.batch_counter, torch.int32),
            self._scalar(float(depth_mean)), self._scalar(float(max(depth_min, 1e-3))),
            self._scalar(float(converge_thresh)),
        )
        # the backfill needs the new keyframe's pose in the ring before kfs.add
        ring_T = self._ring_poses()
        ring_T[ring_slot] = frame.T_f_w.astype(np.float32)
        ring_exp = np.array(
            [self.kfs.exposure[i] if 0 <= i < len(self.kfs.exposure) else 1.0
             for i in self.seed_ring], np.float32)
        ring_exp[ring_slot] = frame.exposure
        self._backfill_new_seeds(frame, ring_T=self._h2d(ring_T), ring_exp=self._h2d(ring_exp))
        return {"kf_pack": kf_pack, "bundle": _Pending(bundle), "seeds_before": seeds_before,
                "refresh_buf": _Pending(refresh_buf)}

    def _kf_map_finish(self, kf_dev: dict) -> int:
        """Host side of the seed harvest: the TEMPORARY lifecycle, promotion
        and activation of converged seeds into the point table with their
        appearance windows (one gather of the converged rows)."""
        seeds_before = kf_dev["seeds_before"]
        b = kf_dev["bundle"].numpy()
        conv = b[:, 0] > 0.5
        stale = b[:, 1] > 0.5
        temp_ids = b[:, 13].astype(np.int32)

        # stale seeds: their TEMPORARY points die with them
        dead_tmp = temp_ids[stale & (temp_ids >= 0)]
        dead_tmp = dead_tmp[self.points.type[dead_tmp] == TYPE_TEMPORARY]
        self.points.release(dead_tmp)

        n_conv = int(conv.sum())
        if n_conv == 0:
            return 0
        # convergence-rate statistic
        n_upd = b[conv, 14]
        if len(n_upd):
            self.mean_converge_frames = 0.7 * self.mean_converge_frames + 0.3 * float(
                np.mean(np.maximum(n_upd, 1.0))
            )

        # converged seeds with a live TEMPORARY point: promote it in place
        w_all = np.where(conv)[0]
        promote = w_all[(temp_ids[w_all] >= 0)]
        promoted = 0
        for s in promote:
            p = int(temp_ids[s])
            if self.points.valid[p] and self.points.type[p] == TYPE_TEMPORARY:
                self.points.type[p] = TYPE_CANDIDATE
                self.points.idist[p] = float(b[s, 12])
                promoted += 1
        w = np.array([s for s in w_all if temp_ids[s] < 0], dtype=int)

        idx = self.points.alloc(len(w))
        m = len(idx)
        if m == 0:
            return promoted
        w = w[:m]
        host_ring = b[w, 2].astype(np.int32)
        self.points.valid[idx] = True
        self.points.type[idx] = TYPE_CANDIDATE
        self.points.host_kf[idx] = self.seed_ring[host_ring]
        self.points.host_px[idx] = b[w, 3:5]
        self.points.host_f[idx] = b[w, 5:8]
        self.points.host_level[idx] = b[w, 8].astype(np.int32)
        self.points.species[idx] = b[w, 9].astype(np.int32)
        self.points.grad[idx] = b[w, 10:12]
        self.points.idist[idx] = b[w, 12]
        wdim = int(seeds_before["host_win"].shape[1])
        gbuf = gather_seed_windows(seeds_before["host_win"], seeds_before["host_anchor"],
                                   self._h2d(w.astype(np.int64))).cpu().numpy()
        win_c, anch_c = crop_window(
            gbuf[:, :wdim * wdim].reshape(-1, wdim, wdim), gbuf[:, wdim * wdim:].astype(np.int32),
            b[w, 3:5], b[w, 8].astype(np.int32),
        )
        self.points.host_win[idx] = win_c
        self.points.host_anchor[idx] = anch_c
        self.points.last_obs_kf[idx] = len(self.kfs.frames) - 1
        self.points.init_patch_from_host(idx)
        self._mark_dirty(idx)
        return m + promoted

    def _add_keyframe_seeds(self, frame: Frame, depth_mean, depth_min,
                            converge_thresh) -> None:
        # occupancy: current observations + matched seed positions
        occ_px = frame.obs["px"][frame.obs["valid"]]
        if self._last_seed_matched is not None:
            sm = self._last_seed_match_px[self._last_seed_matched]
            if len(sm):
                occ_px = np.concatenate([occ_px, sm], axis=0)
        det = self._detect(frame, occ_px)
        f_det = self.cam.cam2world(det["px"]).to(torch.float32)

        self.batch_counter += 1
        ring_slot = frame.kf_index % SEED_RING
        self.seed_ring[ring_slot] = frame.kf_index
        self.seeds = init_seeds(
            self.seeds, det, frame.data["pyr"], f_det,
            self._scalar(ring_slot, torch.int32), self._scalar(self.batch_counter, torch.int32),
            self._scalar(float(depth_mean)), self._scalar(float(max(depth_min, 1e-3))),
            self._scalar(float(converge_thresh)),
        )
        self._backfill_new_seeds(frame)

    def _backfill_new_seeds(self, frame: Frame, ring_T=None, ring_exp=None) -> None:
        """Sweep seeds against the retained pre-frames, synchronously at
        keyframe creation.  Two classes of seed take the sweep: the batch just
        created (the pre-frames predate its host, so parallax is immediate)
        and older seeds that never fused a measurement (retrying a frame
        cannot fuse it twice; a seed with successes is excluded)."""
        new_mask = (
            (self.seeds["batch_id"] == self.batch_counter)
            | (self.seeds["n_updates"] < 0.5)
        ) & self.seeds["valid"]
        if ring_T is None:
            ring_T = self._h2d(self._ring_poses())
        if ring_exp is None:
            ring_exp = self._h2d(self._ring_exposures())
        for pf in list(self.pre_frames):
            if pf is frame or pf.data is None or "sobel_x" not in pf.data:
                continue
            d = pf.data
            self.seeds, _ = update_seeds(
                self.seeds, ring_T, ring_exp,
                d["pyr"], d["sobel_x"], d["sobel_y"],
                self._h2d(pf.T_f_w, torch.float32), self._scalar(pf.exposure),
                self._px_error_dev(), self.cam, update_mask=new_mask,
            )

    def _px_error_dev(self) -> torch.Tensor:
        if self._px_err_dev is None:
            self._px_err_dev = self._scalar(self.px_error_angle)
        return self._px_err_dev

    # ---------------------------------------------------------------- BA
    def _run_ba(self, center: Frame) -> None:
        ba_glue.run_local_ba(self, center)

    # ---------------------------------------------------------------- misc
    def _closest_keyframe(self, T_ref: np.ndarray) -> Frame | None:
        """Closest keyframe by camera distance among the keyframes looking the
        same way (optical axes within 60°) that still hold their pyramid;
        else the last keyframe if it holds one."""
        pos = se3np.translation(se3np.inv(T_ref))
        axis = T_ref[:3, 2]  # camera z-axis in world = R row 2 of world→cam
        best, best_d = None, np.inf
        for kf in self.kfs.frames:
            if kf.data is None or "pyr" not in kf.data:
                continue
            cos = float(np.dot(axis, kf.T_f_w[:3, 2]))
            if cos < 0.5:
                continue
            d = float(np.linalg.norm(kf.pos() - pos))
            if d < best_d:
                best, best_d = kf, d
        if best is None and self.kfs.frames:
            last = self.kfs.last()
            best = last if last.data is not None else None
        return best

    def reset_all(self) -> None:
        """Full reset after prolonged tracking failure: wipe map, seeds and
        counters and re-enter the bootstrap."""
        cfg = self.cfg
        self.points = PointTable(cfg.n_points_ba_max * 2)
        self.kfs = KeyframeWindow(k_all_max=cfg.max_n_kfs, recent=SEED_RING)
        self.points.kfs = self.kfs
        self.seeds = empty_seeds(cfg.n_seeds_max, self.device)
        self.seed_ring = np.full(SEED_RING, -1, np.int32)
        self.batch_counter = 0
        self.stage = STAGE_FIRST
        self.motion_model = se3np.identity()
        self.first_frame = None
        self._init_px = None
        self.regular_counter = 0
        self.n_last_inliers = 0
        self.after_init = False
        self.reloc_fail_count = 0
        self.mean_converge_frames = 6.0
        self.pre_frames.clear()
        self._snap_heavy = None
        self._snap_light = None
        self._dirty_rows = set()
        self._acc = None
        self._last_seed_match_px = None
        self._last_seed_matched = None
        self._bump_map_version()

    RELOC_MAX_FAILURES = 30

    def _relocalize(self, frame: Frame) -> FrameResult:
        if not self.kfs.frames:
            return FrameResult(RESULT_FAILURE, frame.T_f_w)
        res = self._relocalize_attempt(frame)
        if res.status == RESULT_FAILURE:
            self.reloc_fail_count += 1
            if self.reloc_fail_count >= self.RELOC_MAX_FAILURES:
                self.reset_all()
        else:
            self.reloc_fail_count = 0
        return res

    def _relocalizer(self):
        """The coarse tracker of relocalization (IC, 15 iterations a level),
        built once per handler."""
        if self._reloc_tracker is None:
            self._reloc_tracker = make_coarse_tracker(
                self.cam, max_level=self.cfg.klt_max_level,
                min_level=self.cfg.klt_min_level, n_iter=15, inverse=True,
                device=self.device)
        return self._reloc_tracker

    def _relocalize_attempt(self, frame: Frame) -> FrameResult:
        ref = self._closest_keyframe(self.last_frame.T_f_w)
        if ref is None:
            # no stored pyramid: relocalize against the map (the memoized
            # point windows need no keyframe image)
            return self._relocalize_by_map(frame)
        frame.T_f_w = self.last_frame.T_f_w.copy()
        ro = ref.obs
        valid_ref = ro["valid"] & (ro["point_id"] >= 0)
        pid = np.where(valid_ref, ro["point_id"], 0)
        pos_w = self.points.positions(self.kfs.poses)[pid]
        p_ref = se3np.apply(ref.T_f_w, pos_w)
        dist = np.where(valid_ref & (p_ref[:, 2] > 1e-5),
                        np.linalg.norm(p_ref, axis=-1), -1.0).astype(np.float32)
        tout = self._relocalizer()(
            ref.data["pyr"], frame.data["pyr"],
            self._h2d(ro["px"], torch.float32), self._h2d(ro["f"], torch.float32),
            self._h2d(dist),
            self._h2d(se3np.mul(frame.T_f_w, se3np.inv(ref.T_f_w)), torch.float32),
            self._scalar(1.0),
        )
        n_tracked, T_cur_ref = _fetch(tout["n_tracked"], tout["T_cur_ref"])
        if int(n_tracked) > 30:
            frame.T_f_w = se3np.normalize(
                se3np.mul(T_cur_ref.astype(np.float64), ref.T_f_w)
            )
            self.stage = STAGE_DEFAULT
            # the keyframe's device caches are stale (poses BA-corrected
            # since, obs point ids possibly recycled): drop them so the step
            # reads the live host state
            for a in ("T_dev", "obs_dev", "exp_dev", "grad_mean_dev",
                      "intensity_dev"):
                if hasattr(ref, a):
                    setattr(ref, a, None)
            self.last_frame = ref
            return self._process_default(frame)
        # the photometric attempt failed: try the wider-basin map matcher
        return self._relocalize_by_map(frame)

    def _relocalize_by_map(self, frame: Frame) -> FrameResult:
        """Match the memoized point windows and run the pose LM, iterated: the
        first pass closes most of the pose gap, the next match with the
        corrected prior (no keyframe image needed)."""
        frame.T_f_w = self.last_frame.T_f_w.copy()
        frame.exposure = getattr(self.last_frame, "exposure", 1.0)
        n = n_inl = 0
        for attempt in range(4):
            frame.obs = empty_obs(self._n_obs_pad)
            n = self._reproject(frame)
            if n < 8:
                return FrameResult(RESULT_FAILURE, frame.T_f_w, n_matches=n)
            T, _, _, n_inl, _ = self._optimize_pose_host(frame)
            # with a stale prior the NCC-verified matches are trustworthy even
            # when the inlier strip is harsh: adopt the LM pose and re-match
            frame.T_f_w = T
            if n_inl >= 30:
                break
        if n_inl < 30:
            return FrameResult(RESULT_FAILURE, frame.T_f_w, n_matches=n)
        self.stage = STAGE_DEFAULT
        self.motion_model = se3np.identity()
        self.n_last_inliers = n_inl
        self.regular_counter += 1
        return FrameResult(RESULT_FRAME, frame.T_f_w, n, n_inl)

    def _restart(self) -> None:
        self.stage = STAGE_FIRST
        self.first_frame = None
        self._init_px = None

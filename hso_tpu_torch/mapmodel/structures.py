"""Map data model: frames, keyframes, the global point table (host numpy).

The map is fixed-capacity struct-of-arrays with validity masks:

  * ``PointTable`` — the global landmark store.  Each row keeps its host
    feature (bearing, level, gradient) and a 24×24 window of the host image,
    so re-warping reference patches for matching never reads an old keyframe
    pyramid; host poses are read from the live ``kf_poses`` registry.  Each
    row also keeps one patch-source view (``patch_*``) that the matcher warps
    from, refreshed at every keyframe that observes the point.
  * per-frame observation tables (``empty_obs``), slot → point id.
  * ``Frame`` and ``KeyframeWindow`` — host records of frames and keyframes;
    the device pyramid is kept for the ``recent`` newest keyframes only.

A row that ``alloc`` hands out starts with its success/fail counters at 0:
the counters belong to the point, not to the row.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from hso_tpu_torch.math import se3np

# point types (the lifecycle of a map point)
TYPE_DELETED = 0
TYPE_TEMPORARY = 1
TYPE_CANDIDATE = 2
TYPE_UNKNOWN = 3
TYPE_GOOD = 4

HOST_WIN = 24


def crop_window(win: np.ndarray, anchor: np.ndarray, px: np.ndarray,
                level: np.ndarray, out: int = HOST_WIN):
    """Crop stored appearance windows to the point table's ``HOST_WIN``.

    Seed windows are wider (the epipolar search reads a 10×10 patch up to two
    levels coarser); a map point keeps the compact neighbourhood, centred on
    the feature with the clip rule of ``ops.gatherless.clip_anchor``.
    Returns (win_out (N, out, out), anchor_out (N, 2))."""
    n, w_in = win.shape[0], win.shape[1]
    if w_in == out:
        return win, anchor
    scale = 1.0 / (1 << level.astype(np.int64)).astype(np.float64)
    cu = px[:, 0] * scale - anchor[:, 0]
    cv = px[:, 1] * scale - anchor[:, 1]
    ou = np.clip(np.rint(cu).astype(np.int64) - out // 2, 0, w_in - out)
    ov = np.clip(np.rint(cv).astype(np.int64) - out // 2, 0, w_in - out)
    rows = np.arange(n)[:, None, None]
    vv = (ov[:, None] + np.arange(out))[:, :, None]
    uu = (ou[:, None] + np.arange(out))[:, None, :]
    return win[rows, vv, uu], (
        anchor + np.stack([ou, ov], -1).astype(anchor.dtype)
    )


class PointTable:
    """Fixed-capacity landmark SoA (host numpy; device copies made on use)."""

    #: (patch-source member, host member) pairs: a new point's patch source
    #: is its host view
    PATCH_FIELDS = (
        ("patch_kf", "host_kf"), ("patch_px", "host_px"),
        ("patch_f", "host_f"), ("patch_level", "host_level"),
        ("patch_grad", "grad"), ("patch_win", "host_win"),
        ("patch_anchor", "host_anchor"),
    )

    def __init__(self, p_max: int = 4096):
        self.p_max = p_max
        self.valid = np.zeros(p_max, bool)
        self.type = np.zeros(p_max, np.int32)
        self.host_kf = np.zeros(p_max, np.int32)       # global keyframe index
        self.host_px = np.zeros((p_max, 2), np.float32)
        self.host_f = np.zeros((p_max, 3), np.float32)
        self.host_level = np.zeros(p_max, np.int32)
        self.species = np.zeros(p_max, np.int32)       # corner/edgelet/gradient
        self.grad = np.zeros((p_max, 2), np.float32)
        self.idist = np.zeros(p_max, np.float32)
        self.host_win = np.zeros((p_max, HOST_WIN, HOST_WIN), np.float32)
        self.host_anchor = np.zeros((p_max, 2), np.int32)
        self.n_succ = np.zeros(p_max, np.int32)
        self.n_fail = np.zeros(p_max, np.int32)
        self.patch_kf = np.zeros(p_max, np.int32)
        self.patch_px = np.zeros((p_max, 2), np.float32)
        self.patch_f = np.zeros((p_max, 3), np.float32)
        self.patch_level = np.zeros(p_max, np.int32)
        self.patch_grad = np.zeros((p_max, 2), np.float32)
        self.patch_win = np.zeros((p_max, HOST_WIN, HOST_WIN), np.float32)
        self.patch_anchor = np.zeros((p_max, 2), np.int32)
        self._free = list(range(p_max - 1, -1, -1))
        # inverted observation index: per point, the (kf_index, obs_slot)
        # pairs of keyframes observing it.  Entries go stale when BA strips an
        # observation; readers verify against the forward table (live_obs).
        self.obs_refs: list[list[tuple[int, int]]] = [[] for _ in range(p_max)]
        # last keyframe at which the point was registered or observed (drives
        # gc_stale)
        self.last_obs_kf = np.full(p_max, -1, np.int32)
        # the owning KeyframeWindow (set by the pipeline): release() clears the
        # released point's forward observation rows so a recycled row id is
        # never re-admitted through a stale row
        self.kfs = None

    def init_patch_from_host(self, idx) -> None:
        """New points start with the host view as the patch source."""
        for dst, src in self.PATCH_FIELDS:
            getattr(self, dst)[idx] = getattr(self, src)[idx]

    def alloc(self, n: int) -> np.ndarray:
        """Up to ``n`` free rows, lowest first; their counters start at 0."""
        take = min(n, len(self._free))
        idx = np.array([self._free.pop() for _ in range(take)], np.int32)
        self.n_succ[idx] = 0
        self.n_fail[idx] = 0
        return idx

    def release(self, idx) -> None:
        frames = self.kfs.frames if self.kfs is not None else None
        for i in np.atleast_1d(idx):
            if self.valid[i]:
                if frames is not None:
                    for kf, s in self.obs_refs[int(i)]:
                        if kf < len(frames) and frames[kf].obs is not None:
                            ko = frames[kf].obs
                            if ko["point_id"][s] == i:
                                ko["valid"][s] = False
                                ko["point_id"][s] = -1
                self.valid[i] = False
                self.type[i] = TYPE_DELETED
                self.obs_refs[int(i)] = []
                self.last_obs_kf[i] = -1
                self._free.append(int(i))

    def register_obs(self, frame) -> None:
        """Record a keyframe's observations in the inverted index (once per
        keyframe, when its observation table is final)."""
        o = frame.obs
        kf = frame.kf_index
        for i in np.nonzero(o["valid"] & (o["point_id"] >= 0))[0]:
            p = int(o["point_id"][i])
            self.obs_refs[p].append((kf, int(i)))
            self.last_obs_kf[p] = max(self.last_obs_kf[p], kf)

    def live_obs(self, p: int, frames: list) -> list[tuple[int, int]]:
        """Verified (kf_index, slot) observations of point ``p``; drops the
        entries whose forward slot was stripped or reused."""
        fresh = []
        for kf, i in self.obs_refs[p]:
            ko = frames[kf].obs
            if ko is not None and ko["valid"][i] and ko["point_id"][i] == p:
                fresh.append((kf, i))
        self.obs_refs[p] = fresh
        return fresh

    def gc_stale(self, latest_kf: int, grace_kfs: int = 12,
                 pressure: float = 0.75) -> int:
        """Release points not observed in the last ``grace_kfs`` keyframes.
        GOOD points stay (for relocalization by map) until the table is more
        than ``pressure`` full; then the oldest-observed go first."""
        stale = self.valid & (self.last_obs_kf < latest_kf - grace_kfs)
        victims = np.nonzero(stale & (self.type != TYPE_GOOD))[0]
        n = len(victims)
        self.release(victims)
        if self.valid.sum() > pressure * self.p_max:
            good = np.nonzero(stale & (self.type == TYPE_GOOD))[0]
            good = good[np.argsort(self.last_obs_kf[good])]
            n_evict = int(self.valid.sum() - pressure * self.p_max)
            self.release(good[:n_evict])
            n += min(n_evict, len(good))
        return n

    def positions(self, kf_poses: np.ndarray) -> np.ndarray:
        """World positions from host anchoring: T_host_w⁻¹ · (f/idist)."""
        T_h = kf_poses[self.host_kf]
        p_h = self.host_f / np.maximum(self.idist, 1e-10)[:, None]
        return se3np.apply(se3np.inv(T_h), p_h.astype(np.float64))


def empty_obs(n_max: int) -> dict:
    """Per-frame observation table."""
    return {
        "valid": np.zeros(n_max, bool),
        "px": np.zeros((n_max, 2), np.float32),
        "f": np.zeros((n_max, 3), np.float32),
        "level": np.zeros(n_max, np.int32),
        "species": np.zeros(n_max, np.int32),
        "grad": np.zeros((n_max, 2), np.float32),
        "point_id": np.full(n_max, -1, np.int32),
    }


@dataclasses.dataclass
class Frame:
    frame_id: int
    timestamp: float
    T_f_w: np.ndarray                      # (3,4) float64, world→frame
    data: dict                             # device pyramid bundle (pyr/sobel/stats)
    exposure: float = 1.0
    obs: dict = None                       # observation table
    is_keyframe: bool = False
    kf_index: int = -1                     # global keyframe index
    grad_mean: float = 10.0
    intensity_mean: float = 128.0

    def pos(self) -> np.ndarray:
        return se3np.translation(se3np.inv(self.T_f_w))


class KeyframeWindow:
    """Global keyframe registry: host poses, the recent keyframes' pyramids."""

    def __init__(self, k_all_max: int = 1024, recent: int = 8):
        self.k_all_max = k_all_max
        self.poses = np.tile(se3np.identity()[None], (k_all_max, 1, 1))
        self.exposure = np.ones(k_all_max, np.float32)
        self.frames: list[Frame] = []
        self.recent = recent

    def add(self, frame: Frame) -> int:
        idx = len(self.frames)
        assert idx < self.k_all_max
        frame.is_keyframe = True
        frame.kf_index = idx
        self.poses[idx] = frame.T_f_w
        self.exposure[idx] = frame.exposure
        self.frames.append(frame)
        # drop the device pyramid of the keyframe that left the recent window
        if len(self.frames) > self.recent:
            self.frames[-self.recent - 1].data = None
        return idx

    def sync_pose(self, idx: int, T: np.ndarray) -> None:
        self.poses[idx] = T
        self.frames[idx].T_f_w = T

    def last(self) -> Frame:
        return self.frames[-1]

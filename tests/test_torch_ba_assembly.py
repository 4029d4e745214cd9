"""The windowed BA's assembly as array operations over the keyframe-major
observation table (``pipeline/ba_glue.py``, ``mapmodel/structures.py``)
against the per-observation loops it replaced, kept below verbatim as the
reference: ``covisible_keyframes``, ``assemble`` and ``write_back`` walking
the inverted point→(keyframe, slot) index of lists (``RefIndex``, the
``obs_refs``/``live_obs`` that ``PointTable`` kept, fed by the same
``register_obs`` and ``release`` calls).

On handler states: the boot checkpoint; a handler driven from it through four
keyframe events of the bench's sweep (BA strips, released and reused point
rows, so stale index entries); a window wider than ``n_kfs_window``; a point
set cut by ``n_points_ba_max``; points whose host keyframe gets no slot;
keyframes that enter as fixed targets, in the order of their first cell.  The
two give the same window, slots, points, every problem array with its dtype,
and after the write-back (a made-up solver output with outliers) the same
inverse distances and observation cells, bit for bit.  Then the table's
write-through: a strip and a release are gone from the next assembly, a
checkpoint restores the same problem, a repeated (point, keyframe) cell
raises."""

import dataclasses

import numpy as np
import pytest
import torch

from hso_tpu_torch.bench import BOOT_NPZ, bench_camera, bench_scene, render_frames, trajectory
from hso_tpu_torch.config import Config
from hso_tpu_torch.math import se3np
from hso_tpu_torch.pipeline import ba_glue
from hso_tpu_torch.pipeline.frame_handler import RESULT_KEYFRAME, FrameHandler
from hso_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

torch.set_num_threads(1)

N_EVENTS = 4                 # keyframe events driven from the checkpoint
N_STRIP = 30                 # observations stripped after each


# ------------------------------------------------------------ the reference
class RefIndex:
    """The inverted point→observers index as ``PointTable`` kept it: per
    point, the (kf_index, obs_slot) pairs of the keyframes registered while
    observing it; entries go stale when BA strips an observation, and
    ``live_obs`` verifies them against the forward table."""

    def __init__(self, p_max: int):
        self.obs_refs: list[list[tuple[int, int]]] = [[] for _ in range(p_max)]
        self.released: set[int] = set()

    def register_obs(self, frame) -> None:
        o = frame.obs
        kf = frame.kf_index
        for i in np.nonzero(o["valid"] & (o["point_id"] >= 0))[0]:
            p = int(o["point_id"][i])
            self.obs_refs[p].append((kf, int(i)))

    def release(self, pts, idx) -> None:
        for i in np.atleast_1d(idx):
            if pts.valid[i]:
                self.obs_refs[int(i)] = []
                self.released.add(int(i))

    def live_obs(self, p: int, frames: list) -> list[tuple[int, int]]:
        fresh = []
        for kf, i in self.obs_refs[p]:
            ko = frames[kf].obs
            if ko is not None and ko["valid"][i] and ko["point_id"][i] == p:
                fresh.append((kf, i))
        self.obs_refs[p] = fresh
        return fresh


def track(h: FrameHandler) -> RefIndex:
    """Feed a ``RefIndex`` from the handler's point table's own calls."""
    pts = h.points
    ref = RefIndex(pts.p_max)
    register, release = pts.register_obs, pts.release

    def register_obs(frame):
        ref.register_obs(frame)
        register(frame)

    def release_(idx):
        ref.release(pts, idx)
        release(idx)

    pts.register_obs, pts.release = register_obs, release_
    return ref


class _Points:
    def __init__(self, pts, ref):
        self._pts, self._ref = pts, ref

    def live_obs(self, p, frames):
        return self._ref.live_obs(p, frames)

    def __getattr__(self, name):
        return getattr(self._pts, name)


class View:
    """The handler with another ``cfg``; with ``ref``, its points answer
    ``live_obs`` through the reference index."""

    def __init__(self, h, cfg, ref=None):
        self._h, self.cfg = h, cfg
        if ref is not None:
            self.points = _Points(h.points, ref)

    def __getattr__(self, name):
        return getattr(self._h, name)


def ref_covisible_keyframes(handler, center) -> list[int]:
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


def ref_assemble(handler, center) -> dict | None:
    """The windowed BA problem around keyframe ``center`` as host arrays, with
    the slots the write-back needs; None when the window is too small."""
    cfg = handler.cfg
    K = cfg.n_kfs_window
    P = cfg.n_points_ba_max

    core = ref_covisible_keyframes(handler, center)
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


def ref_write_back(handler, center, prob: dict, out: dict) -> dict:
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


# ------------------------------------------------------------------ states
def boot_handler(cfg=None):
    h = FrameHandler(bench_camera(), cfg or Config(), device="cpu")
    ref = track(h)
    load_checkpoint(h, BOOT_NPZ, resume_stage="default")
    return h, ref


@pytest.fixture(scope="module")
def states():
    """The boot checkpoint, a handler driven from it through
    ``N_EVENTS`` keyframe events of the bench's sweep, and the boot checkpoint
    with every point hosted in keyframe 0.  The box has no BA
    outliers, so after each event ``N_STRIP`` observations of the older
    keyframes are stripped as BA strips them (in the forward table)."""
    boot = boot_handler()
    h, ref = boot_handler()
    start = h.frame_count
    frames = render_frames(bench_scene(h.cam), trajectory(start + 6 * N_EVENTS)[start:])
    rng = np.random.default_rng(5)
    n_kf = k = 0
    while n_kf < N_EVENTS:
        if h.add_image(frames[k], ts=float(start + k)).status == RESULT_KEYFRAME:
            n_kf += 1
            for _ in range(N_STRIP):
                o = h.kfs.frames[int(rng.integers(0, len(h.kfs.frames) - 1))].obs
                i = rng.choice(np.nonzero(o["valid"] & (o["point_id"] >= 0))[0])
                o["valid"][i], o["point_id"][i] = False, -1
        k += 1
    # what the loops had to verify: stale index entries, reused point rows
    pts, frames_kf = h.points, h.kfs.frames
    n_refs = sum(len(r) for r in ref.obs_refs)
    n_live = sum(len(ref.live_obs(p, frames_kf)) for p in range(pts.p_max))
    assert n_live < n_refs and pts.valid[list(ref.released)].any()
    # every point hosted in keyframe 0: the keyframes outside a small window
    # enter as fixed targets only, in the order of their first cell
    one_host = boot_handler()
    one_host[0].points.host_kf[:] = 0
    return {"boot": boot, "events": (h, ref), "one_host": one_host}


def problem_equal(a: dict, b: dict) -> None:
    assert list(a["kf_slot"].items()) == list(b["kf_slot"].items())
    assert list(a["point_set"]) == list(b["point_set"])
    assert a["kw"] == b["kw"] and a["n_obs"] == b["n_obs"]
    for k in ("T_kf", "free", "idist", "pvalid", "src_kf", "src_i"):
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert a["obs"].keys() == b["obs"].keys()
    for k in a["obs"]:
        assert a["obs"][k].dtype == b["obs"][k].dtype, k
        assert np.array_equal(a["obs"][k], b["obs"][k]), k


def made_up_solve(prob: dict, seed: int) -> dict:
    """A solver's output for ``prob``: moved poses and inverse distances (some
    at 0, which the write-back skips), about one observation in six an
    outlier."""
    rng = np.random.default_rng(seed)
    K, P = prob["kw"]["n_kf"], prob["kw"]["n_pts"]
    idist = prob["idist"] * rng.uniform(0.9, 1.1, P).astype(np.float32)
    idist[rng.random(P) < 0.05] = 0.0
    return {k: torch.as_tensor(v) for k, v in dict(
        T_kf=prob["T_kf"] + rng.normal(0, 1e-3, (K, 3, 4)).astype(np.float32),
        idist=idist, obs_inlier=rng.random((P, K)) > 0.17,
        chi2_init=np.float32(2.5), chi2_final=np.float32(1.25)).items()}


def map_state(h) -> dict:
    n = len(h.kfs.frames)
    return dict(idist=h.points.idist.copy(), valid=h.kfs.obs["valid"][:n].copy(),
                point_id=h.kfs.obs["point_id"][:n].copy(), reg_pid=h.kfs.reg_pid[:n].copy())


def restore(h, st: dict) -> None:
    n = len(h.kfs.frames)
    h.points.idist[:] = st["idist"]
    for k in ("valid", "point_id"):
        h.kfs.obs[k][:n] = st[k]
    h.kfs.reg_pid[:n] = st["reg_pid"]


def window_points(h, window) -> int:
    """How many distinct valid points the window's keyframes observe."""
    o = h.kfs.obs
    pid = o["point_id"][window][o["valid"][window] & (o["point_id"][window] >= 0)]
    return len(np.unique(pid[h.points.valid[pid]]))


CASES = {
    "boot": ("boot", -1, {}),
    "events": ("events", -1, {}),
    "events_older_centre": ("events", -3, {}),
    "window_over_slots": ("events", -1, dict(n_kfs_window=4)),
    "points_capped": ("boot", -1, dict(n_points_ba_max=64)),
    "host_without_slot": ("events", -1, "window"),   # slots for the window alone
    # a small core: the other keyframes enter as fixed hosts and targets, in
    # the order the points and their cells meet them, while slots last
    "fixed_targets": ("events", -1, dict(core_n_kfs=2)),
    "fixed_targets_over_slots": ("events", -1, dict(core_n_kfs=2, n_kfs_window=6)),
    "targets_by_first_cell": ("one_host", -1, dict(core_n_kfs=1, n_kfs_window=5)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_array_assembly_is_the_loop_assembly(states, case):
    name, c, over = CASES[case]
    h, ref = states[name]
    center = h.kfs.frames[c]
    cfg = h.cfg
    if over == "window":
        window = ref_covisible_keyframes(View(h, cfg, ref), center) + [center.kf_index]
        over = dict(n_kfs_window=len(set(window)))
    cfg = dataclasses.replace(cfg, **over)
    old, new = View(h, cfg, ref), View(h, cfg)

    window = ba_glue.covisible_keyframes(new, center)
    assert window == ref_covisible_keyframes(old, center) and len(window) >= 2
    before = map_state(h)
    want, got = ref_assemble(old, center), ba_glue.assemble(new, center)
    assert want is not None and got is not None
    problem_equal(want, got)
    assert got["n_obs"] > 100
    window = window + [center.kf_index]
    if case == "window_over_slots":
        assert len(set(window)) > cfg.n_kfs_window
    if case == "points_capped":
        assert len(got["point_set"]) == cfg.n_points_ba_max < window_points(h, window)
    if case == "host_without_slot":
        assert len(got["point_set"]) < window_points(h, window)
    if case.startswith("fixed_targets") or case == "targets_by_first_cell":
        assert len(got["kf_slot"]) > len(set(window))

    out = made_up_solve(want, seed=len(case))
    try:
        r_want = ref_write_back(old, center, want, out)
        after_want = map_state(h)
        restore(h, before)
        r_got = ba_glue.write_back(new, center, got, out)
        after_got = map_state(h)
    finally:
        restore(h, before)
    assert r_want == r_got and r_got["n_stripped"] > 10
    for k in ("idist", "valid", "point_id"):
        assert np.array_equal(after_want[k], after_got[k]), k
    assert not np.array_equal(after_got["idist"], before["idist"])


def _strip_and_release(request, tmp_path):
    """A strip and a release leave the next assembly; the loops agree."""
    h, ref = boot_handler()
    center = h.kfs.frames[-1]
    prob = ba_glue.assemble(h, center)
    out = made_up_solve(prob, seed=1)
    ba_glue.write_back(h, center, prob, out)
    bad = ~out["obs_inlier"].numpy() & (prob["src_kf"] >= 0)
    stripped = set(zip(prob["src_kf"][bad].tolist(), prob["src_i"][bad].tolist()))
    assert stripped
    # a windowed point with observations in two keyframes or more
    s = int(np.argmax(prob["obs"]["valid"].sum(1) >= 2))
    p = int(prob["point_set"][s])
    cells = prob["src_kf"][s][prob["src_kf"][s] >= 0], prob["src_i"][s][prob["src_kf"][s] >= 0]
    h.points.release([p])
    assert not h.kfs.obs["valid"][cells].any() and (h.kfs.obs["point_id"][cells] == -1).all()
    again = ba_glue.assemble(h, center)
    problem_equal(ref_assemble(View(h, h.cfg, ref), center), again)
    live = again["src_kf"] >= 0
    seen = set(zip(again["src_kf"][live].tolist(), again["src_i"][live].tolist()))
    assert not seen & stripped
    assert p not in again["point_set"].tolist()
    assert not seen & set(zip(*(c.tolist() for c in cells)))


def _checkpoint(request, tmp_path):
    """A checkpoint restores the same problem as the handler that saved it."""
    h, _ = request.getfixturevalue("states")["events"]
    path = str(tmp_path / "events.npz")
    save_checkpoint(h, path)
    h2 = FrameHandler(bench_camera(), Config(), device="cpu")
    load_checkpoint(h2, path, resume_stage="default")
    for c in (-1, -2):
        problem_equal(ba_glue.assemble(h, h.kfs.frames[c]), ba_glue.assemble(h2, h2.kfs.frames[c]))
    assert np.array_equal(h.kfs.live(), h2.kfs.live())


def _duplicate(request, tmp_path):
    """A repeated live (point, keyframe) cell raises, in both versions."""
    h, ref = boot_handler()
    center = h.kfs.frames[-1]
    prob = ba_glue.assemble(h, center)
    s, t = np.argwhere(prob["obs"]["valid"])[0]
    kf, i = int(prob["src_kf"][s, t]), int(prob["src_i"][s, t])
    p = int(prob["point_set"][s])
    o = h.kfs.frames[kf].obs
    j = int(np.nonzero(~o["valid"])[0][0])
    for k in o:
        o[k][j] = o[k][i]
    h.kfs.reg_pid[kf, j] = p
    ref.obs_refs[p].append((kf, j))
    for assemble, handler in ((ba_glue.assemble, h), (ref_assemble, View(h, h.cfg, ref))):
        with pytest.raises(AssertionError, match=f"duplicate observation of point {p} "
                                                 f"in keyframe {kf}"):
            assemble(handler, center)


WRITE_THROUGH = {"strip_and_release": _strip_and_release, "checkpoint": _checkpoint,
                 "duplicate": _duplicate}


@pytest.mark.parametrize("case", list(WRITE_THROUGH))
def test_table_write_through(case, request, tmp_path):
    WRITE_THROUGH[case](request, tmp_path)

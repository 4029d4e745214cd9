"""Map-state checkpoints, and the state the per-frame step and the scan carry:
snapshots and seed tables from numpy arrays and from a saved checkpoint.

A checkpoint is one plain ``.npz`` (point table, keyframe poses and
observation tables, seed state, pipeline counters, the last keyframe's
pyramid), the layout the JAX package writes and reads: a file written by
either side loads into the other's ``FrameHandler``.  It is read here with
numpy alone.  :func:`save_checkpoint`/:func:`load_checkpoint` take a
:class:`~hso_tpu_torch.pipeline.frame_handler.FrameHandler`; the
evolving-map scan's state (:func:`scan_state_from_checkpoint`) adds the map
state its keyframe work rewrites.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from hso_tpu_torch.mapping.depth_filter import empty_seeds
from hso_tpu_torch.math import se3np
from hso_tpu_torch.pipeline.fused_step import pack_light
from hso_tpu_torch.pipeline.keyframe import R_RES

SNAP_KEYS = ("pos_w", "kf_poses", "kf_exposure", "ring_T", "ring_exp", "pt_pack",
             "species", "light", "host_pack")
_INT_KEYS = ("species", "light")


def snapshot_from_numpy(snap: dict, device="cuda") -> dict:
    """The step's ``snap`` dict as tensors on ``device``: float members as
    float32, ``species`` and ``light`` as int32.  Unknown keys are refused."""
    out = {}
    for k, v in snap.items():
        if k not in SNAP_KEYS:
            raise KeyError(f"unknown snapshot member {k!r}")
        dtype = torch.int32 if k in _INT_KEYS else torch.float32
        out[k] = torch.as_tensor(np.ascontiguousarray(v), device=device).to(dtype).contiguous()
    return out


def prev_obs_from_numpy(obs: dict, device="cuda") -> dict:
    """The step's ``prev_obs`` dict (px, f float32; pid int32; valid bool)."""
    dev = torch.device(device)
    return {
        "px": torch.as_tensor(np.asarray(obs["px"], np.float32), device=dev),
        "f": torch.as_tensor(np.asarray(obs["f"], np.float32), device=dev),
        "pid": torch.as_tensor(np.asarray(obs["pid"], np.int32), device=dev),
        "valid": torch.as_tensor(np.asarray(obs["valid"], bool), device=dev),
    }


def seeds_from_numpy(d: dict, device="cuda") -> dict:
    """The step's seed table as tensors on ``device``, with the members and
    types of :func:`~hso_tpu_torch.mapping.depth_filter.empty_seeds` (bool,
    int32, float32).  ``d`` must hold every member; keys that are not members
    of the table (a loader's ``ring``, say) are not taken."""
    dev = torch.device(device)
    n = np.asarray(d["valid"]).shape[0]
    out = {}
    for k, proto in empty_seeds(n, "cpu").items():
        a = np.ascontiguousarray(d[k])
        if a.shape != tuple(proto.shape):
            raise ValueError(f"seed member {k!r}: expected shape {tuple(proto.shape)}, "
                             f"got {a.shape}")
        out[k] = torch.as_tensor(a).to(proto.dtype).to(dev).contiguous()
    return out


def seeds_to_numpy(seeds: dict) -> dict:
    """The seed table as numpy arrays (bool, int32, float32)."""
    return {k: v.detach().cpu().numpy() for k, v in seeds.items()}


def point_positions(host_kf, host_f, idist, kf_poses) -> np.ndarray:
    """World positions from host anchoring: T_host_w⁻¹ · (f / idist), float64."""
    T_h = kf_poses[host_kf]
    p_h = host_f / np.maximum(idist, 1e-10)[:, None]
    return se3np.apply(se3np.inv(T_h), p_h.astype(np.float64))


def pt_pack_rows(z, prefix: str) -> np.ndarray:
    """Packed per-point patch-source rows (layout: ``fused_step.PT_COLS``)
    from checkpoint arrays; ``prefix`` is ``"patch"`` (the matcher's source
    view) or ``"host"`` (the anchoring view)."""
    if prefix == "patch":
        win, px, f = z["pt_patch_win"], z["pt_patch_px"], z["pt_patch_f"]
        anc, lvl, grad, kf = (z["pt_patch_anchor"], z["pt_patch_level"],
                              z["pt_patch_grad"], z["pt_patch_kf"])
    else:
        win, px, f = z["pt_host_win"], z["pt_host_px"], z["pt_host_f"]
        anc, lvl, grad, kf = (z["pt_host_anchor"], z["pt_host_level"], z["pt_grad"],
                              z["pt_host_kf"])
    n = win.shape[0]
    return np.concatenate([
        win.reshape(n, -1), px, f, anc, lvl[:, None], grad,
        z["pt_species"][:, None], kf[:, None],
    ], axis=1).astype(np.float32)


def track_state_from_checkpoint(path: str, cam, cfg, device="cuda"):
    """Everything the tracking step needs to continue from a checkpoint whose
    last frame is a keyframe with a stored pyramid.

    Returns ``(snap, prev_pyr, prev_grad_mean, prev_intensity, exposure_prev,
    T_prev, prev_obs, frame_count)``: the map snapshot, the last keyframe's
    pyramid and photometric statistics, its pose (float32 tensor), its
    observation table as ``prev_obs``, and the index of the next frame.
    ``cam`` is accepted for symmetry with the pipeline; the checkpoint
    already holds bearings."""
    z = np.load(path, allow_pickle=False)
    dev = torch.device(device)
    kf_poses = z["kf_poses"]
    kf_exposure = z["kf_exposure"]
    n_kf = int(z["kf_count"])
    if n_kf < 1 or "lastkf_pyr_0" not in z.files:
        raise ValueError(f"{path}: no keyframe with a stored pyramid to resume from")
    ring = z["seed_ring"]
    snap_np = {
        "pos_w": point_positions(z["pt_host_kf"], z["pt_host_f"], z["pt_idist"],
                                 kf_poses).astype(np.float32),
        "kf_poses": kf_poses.astype(np.float32),
        "kf_exposure": kf_exposure,
        "ring_T": np.stack([kf_poses[i] if i >= 0 else se3np.identity()
                            for i in ring]).astype(np.float32),
        "ring_exp": np.array([kf_exposure[i] if i >= 0 else 1.0 for i in ring], np.float32),
        "pt_pack": pt_pack_rows(z, "patch"),
        "species": z["pt_species"],
        "light": pack_light(z["pt_type"], z["pt_valid"]),
    }
    if cfg.patch_source == "closest":
        snap_np["host_pack"] = pt_pack_rows(z, "host")
    snap = snapshot_from_numpy(snap_np, dev)

    pyr = []
    while f"lastkf_pyr_{len(pyr)}" in z.files:
        pyr.append(torch.as_tensor(z[f"lastkf_pyr_{len(pyr)}"], dtype=torch.float32,
                                   device=dev))
    grad_mean, intensity_mean, exposure = (float(x) for x in z["lastkf_stats"])

    last = n_kf - 1
    ov = z[f"kf{last}_obs_valid"] & (z[f"kf{last}_obs_point_id"] >= 0)
    prev_obs = prev_obs_from_numpy({
        "px": z[f"kf{last}_obs_px"], "f": z[f"kf{last}_obs_f"],
        "pid": np.where(ov, z[f"kf{last}_obs_point_id"], 0), "valid": ov}, dev)
    T_prev = torch.as_tensor(z[f"kf{last}_T"].astype(np.float32), device=dev)
    return (snap, tuple(pyr), grad_mean, intensity_mean, exposure, T_prev, prev_obs,
            int(z["frame_count"]))


def frame_state_from_checkpoint(path: str, cam, cfg, device="cuda"):
    """Everything the whole per-frame step needs to continue from a
    checkpoint: what :func:`track_state_from_checkpoint` returns, then the
    depth filter's state.

    Returns ``(snap, prev_pyr, prev_grad_mean, prev_intensity, exposure_prev,
    T_prev, prev_obs, frame_count, seeds, seed_ring, batch_counter,
    px_error_angle)``: ``seeds`` is the seed table on ``device``,
    ``seed_ring`` (numpy int32) maps each host ring slot to its keyframe
    index (-1: free), ``batch_counter`` counts keyframe seed batches, and
    ``px_error_angle`` is the bearing angle of a one-pixel error."""
    track = track_state_from_checkpoint(path, cam, cfg, device)
    z = np.load(path, allow_pickle=False)
    seeds = seeds_from_numpy({k[len("seed_"):]: z[k] for k in z.files
                              if k.startswith("seed_")}, device)
    px_error_angle = float(math.atan(1.0 / (2.0 * cam.focal_mean)) * 2.0)
    return track + (seeds, z["seed_ring"].astype(np.int32), int(z["batch_counter"]),
                    px_error_angle)


#: point-table members the keyframe work rewrites (padded to the scan's rows)
SCAN_MUT_KEYS = ("light", "pos_w", "pt_pack", "species")


def initial_obs_grid(z, n_rows: int, kw: int) -> np.ndarray:
    """The dense (n_rows, kw, 7) observation ring of the windowed BA, rows
    [meas_u, meas_v, grad_u, grad_v, edgelet, level, valid], filled from the
    stored observation tables of the checkpoint's last ``kw`` keyframes
    (column = keyframe index mod ``kw``)."""
    pack = np.zeros((n_rows, kw, 7), np.float32)
    n_kf = int(z["kf_count"])
    for i in range(max(0, n_kf - kw), n_kf):
        c = i % kw
        pre = f"kf{i}_obs_"
        sel = z[pre + "valid"] & (z[pre + "point_id"] >= 0)
        pid = z[pre + "point_id"][sel]
        f = z[pre + "f"][sel]
        pack[pid, c, 0:2] = f[:, :2] / np.maximum(f[:, 2:3], 1e-9)
        pack[pid, c, 2:4] = z[pre + "grad"][sel]
        pack[pid, c, 4] = z[pre + "species"][sel] == 1
        pack[pid, c, 5] = z[pre + "level"][sel]
        pack[pid, c, 6] = 1.0
    return pack


def scan_state_from_checkpoint(path: str, cam, cfg, device="cuda"):
    """The evolving-map scan's start state: :func:`frame_state_from_checkpoint`
    and on top of it the map state that the keyframe work carries.

    The point table gets ``R_RES`` rows for activated seeds (the keyframe
    work's ring) and one trash row that absorbs masked writes
    (``P_T = P + R_RES + 1``).  Returns
    ``(carry, meta)``: ``carry`` holds the frame-to-frame state (``T``,
    ``pyr``, ``grad_mean``, ``intensity``, ``exposure``, ``obs``, ``seeds``,
    ``acc`` (2, P_T) and ``st``, the map state); ``meta`` the scan's
    constants (``frame_count``, ``px_error_angle``, ``p0`` = P).

    ``st`` holds the snapshot members the step reads (``light``, ``pos_w``,
    ``pt_pack``, ``species`` padded to P_T; ``kf_poses``, ``kf_exposure``,
    ``ring_T``, ``ring_exp``), the seed ring's keyframe indices ``ring_kf``,
    the BA anchoring (``f_host``, ``host_kf`` padded with -1, ``idist``), the
    (P_T, K, 7) observation ring ``ba_pack`` (K = ``cfg.n_kfs_window``), the
    activation cursor and the counters ``kf_count`` and ``batch``, each a
    0-d int32 tensor on ``device`` as the JAX bench carries them
    (``bench.py:353-354``), so the keyframe body reads none of them on the
    host."""
    dev = torch.device(device)
    (snap, prev_pyr, grad_mean, intensity, exposure, T_prev, prev_obs, frame_count, seeds,
     seed_ring, batch_counter, px_error_angle) = frame_state_from_checkpoint(path, cam, cfg, dev)
    z = np.load(path, allow_pickle=False)
    p0 = int(snap["pos_w"].shape[0])
    p_t = p0 + R_RES + 1

    def pad(a, fill=0):
        out = torch.full((p_t,) + tuple(a.shape[1:]), fill, dtype=a.dtype, device=dev)
        out[:p0] = a
        return out

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

    st = {k: pad(snap[k]) for k in SCAN_MUT_KEYS}
    st.update({k: snap[k] for k in ("kf_poses", "kf_exposure", "ring_T", "ring_exp")})
    st["ring_kf"] = t(seed_ring, torch.int32)
    st["f_host"] = pad(t(z["pt_host_f"], torch.float32))
    st["host_kf"] = pad(t(z["pt_host_kf"], torch.int32), fill=-1)
    st["idist"] = pad(t(z["pt_idist"], torch.float32))
    st["ba_pack"] = t(initial_obs_grid(z, p_t, int(cfg.n_kfs_window)), torch.float32)
    st["cursor"] = torch.zeros((), dtype=torch.int32, device=dev)
    st["kf_count"] = torch.full((), int(z["kf_count"]), dtype=torch.int32, device=dev)
    st["batch"] = torch.full((), int(batch_counter), dtype=torch.int32, device=dev)
    carry = dict(T=T_prev, pyr=prev_pyr,
                 grad_mean=torch.tensor(grad_mean, dtype=torch.float32, device=dev),
                 intensity=torch.tensor(intensity, dtype=torch.float32, device=dev),
                 exposure=torch.tensor(exposure, dtype=torch.float32, device=dev),
                 obs=prev_obs, seeds=seeds,
                 acc=torch.zeros((2, p_t), dtype=torch.int32, device=dev), st=st)
    return carry, dict(frame_count=frame_count, px_error_angle=px_error_angle, p0=p0)


#: point-table members in the checkpoint, as ``pt_<name>``
PT_SAVED = ("valid", "type", "host_kf", "host_px", "host_f", "host_level", "species", "grad",
            "idist", "host_win", "host_anchor", "n_succ", "n_fail", "patch_kf", "patch_px",
            "patch_f", "patch_level", "patch_grad", "patch_win", "patch_anchor", "last_obs_kf")


def save_checkpoint(handler, path: str) -> None:
    """Write the handler's map state (point table, keyframe poses and
    observation tables, seed table, pipeline counters, the last keyframe's
    pyramid and statistics) to ``path`` as an uncompressed ``.npz``."""
    pts = handler.points
    blobs = {f"pt_{k}": getattr(pts, k) for k in PT_SAVED}
    blobs.update({
        "kf_poses": handler.kfs.poses, "kf_exposure": handler.kfs.exposure,
        "kf_count": np.int64(len(handler.kfs.frames)),
        "batch_counter": np.int64(handler.batch_counter),
        "frame_count": np.int64(handler.frame_count),
        "seed_ring": handler.seed_ring,
        "motion_model": handler.motion_model,
        "mean_converge_frames": np.float64(handler.mean_converge_frames),
    })
    for i, kf in enumerate(handler.kfs.frames):
        blobs[f"kf{i}_T"] = kf.T_f_w
        blobs[f"kf{i}_ts"] = np.float64(kf.timestamp)
        for k, v in kf.obs.items():
            blobs[f"kf{i}_obs_{k}"] = v
    # the last keyframe's pyramid lets the photometric relocalizer (or the
    # default path, with resume_stage="default") run right after a resume
    last = handler.kfs.frames[-1] if handler.kfs.frames else None
    if last is not None and last.data is not None:
        for lvl, img in enumerate(last.data["pyr"]):
            blobs[f"lastkf_pyr_{lvl}"] = img.detach().cpu().numpy()
        blobs["lastkf_stats"] = np.array([last.grad_mean, last.intensity_mean, last.exposure])
    for k, v in seeds_to_numpy(handler.seeds).items():
        blobs[f"seed_{k}"] = v
    # uncompressed: the bulk is float32 image windows, where deflate costs
    # minutes for a few percent
    np.savez(path, **blobs)


def load_checkpoint(handler, path: str, resume_stage: str | None = None) -> None:
    """Restore map state into a fresh ``FrameHandler`` (same camera and
    config); the last keyframe's pyramid goes to ``handler.device``.

    ``resume_stage="default"`` resumes straight into the default tracking
    path (valid only when the next frame is adjacent to the saved last
    keyframe, whose pyramid is stored); the default ``None`` re-enters
    through RELOCALIZING."""
    from hso_tpu_torch.mapmodel.structures import NO_KF, Frame, empty_obs
    from hso_tpu_torch.pipeline.frame_handler import STAGE_DEFAULT, STAGE_RELOC

    z = np.load(path, allow_pickle=False)
    pts = handler.points
    for k in PT_SAVED:
        if f"pt_{k}" in z.files:
            setattr(pts, k, z[f"pt_{k}"].copy())
    if "pt_patch_kf" not in z.files:       # written before patch sources existed
        pts.init_patch_from_host(np.arange(pts.p_max))
    pts._free = [i for i in range(pts.p_max - 1, -1, -1) if not pts.valid[i]]

    handler.kfs.poses = z["kf_poses"].copy()
    handler.kfs.exposure = z["kf_exposure"].copy()
    handler.kfs.frames = []
    for i in range(int(z["kf_count"])):
        obs = empty_obs(handler._n_obs_pad)
        for k in obs:
            obs[k] = z[f"kf{i}_obs_{k}"].copy()
        frame = Frame(
            frame_id=-1, timestamp=float(z[f"kf{i}_ts"]), T_f_w=z[f"kf{i}_T"].copy(),
            data=None, obs=obs, is_keyframe=True, kf_index=i)
        handler.kfs.frames.append(frame)
        handler.kfs.bind_obs(frame)

    # the inverted point→(kf, slot) index is derived state: rebuilt here
    pts.first_obs_kf[:] = NO_KF
    for f in handler.kfs.frames:
        pts.register_obs(f)

    if "lastkf_pyr_0" in z.files and handler.kfs.frames:
        pyr = []
        while f"lastkf_pyr_{len(pyr)}" in z.files:
            pyr.append(torch.as_tensor(z[f"lastkf_pyr_{len(pyr)}"], dtype=torch.float32)
                       .to(handler.device))
        last = handler.kfs.frames[-1]
        last.data = {"pyr": tuple(pyr)}
        gm, im, exp = z["lastkf_stats"]
        last.grad_mean = float(gm)
        last.intensity_mean = float(im)
        last.exposure = float(exp)

    handler.seeds = seeds_from_numpy({k[len("seed_"):]: z[k] for k in z.files
                                      if k.startswith("seed_")}, handler.device)
    handler.batch_counter = int(z["batch_counter"])
    handler.frame_count = int(z["frame_count"])
    handler.seed_ring = z["seed_ring"].copy()
    handler.motion_model = z["motion_model"].copy()
    handler.mean_converge_frames = float(z["mean_converge_frames"])
    handler.last_frame = handler.kfs.frames[-1] if handler.kfs.frames else None
    if (resume_stage == "default" and handler.last_frame is not None
            and handler.last_frame.data is not None):
        handler.stage = STAGE_DEFAULT
    else:
        handler.stage = STAGE_RELOC

"""Map and seed state carried into the per-frame step: snapshots and seed
tables from numpy arrays and from a saved checkpoint.

The checkpoint is the JAX package's plain ``.npz`` (point table, keyframe
poses and observation tables, seed state, pipeline counters, the last
keyframe's pyramid); it is read here with numpy alone.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from hso_tpu_torch.mapping.depth_filter import empty_seeds
from hso_tpu_torch.math import se3np
from hso_tpu_torch.pipeline.fused_step import pack_light

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

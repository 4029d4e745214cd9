"""The evolving-map scan: the per-frame step over a sequence of frames, with
the keyframe work on a schedule the host knows.

At every frame ``run_scan`` runs the whole per-frame step
(:func:`hso_tpu_torch.pipeline.fused_step.make_frame_step`) against the map
state carried in ``st``; on the frames where ``i % KF_EVERY == KF_EVERY - 1``
it then runs :func:`hso_tpu_torch.pipeline.keyframe.keyframe_work`, which
mutates the map (BA write-back, activated seeds, new seeds).  The carry is
the pose, the pyramid and its statistics, the exposure, the tracking
reference (``obs``), the seed table, the point success/fail counters
(``acc``) and the map state ``st``.

On the card the step is a :class:`~hso_tpu_torch.pipeline.step_graph.StepGraph`
by default (``make_scan_step(..., graph=False)`` gives the eager step): a
frame is one graph replay and waits on nothing; the eager step waits for the
device at its FC/IC choice (and on an FC frame once an LM iteration).  The
keyframe body waits on nothing.  A graph's outputs are overwritten two frames
later: the carry lives one frame, and the per-frame records are copies.
"""

from __future__ import annotations

import numpy as np
import torch

from hso_tpu_torch.pipeline.fused_step import make_frame_step, make_track_step
from hso_tpu_torch.pipeline.keyframe import keyframe_work
from hso_tpu_torch.pipeline.step_graph import StepGraph

#: snapshot members the step reads from the scan's map state
SNAP_FROM_ST = ("light", "pos_w", "pt_pack", "species", "kf_poses", "kf_exposure", "ring_T",
                "ring_exp")
#: keyframe cadence of the scan (one keyframe event every KF_EVERY frames)
KF_EVERY = 6


def frame_grid(cam, cfg) -> tuple:
    """(cell, rows, cols) of the candidate-selection grid."""
    cell = max(int(np.sqrt(cam.width * cam.height / cfg.max_fts) * 0.8), 16)
    return (cell, -(-cam.height // cell), -(-cam.width // cell))


def obs_slots(cam, cfg) -> int:
    """Fixed slot count of the step's observation tables."""
    grid = frame_grid(cam, cfg)
    return max(cfg.n_fts_max, grid[1] * grid[2])


def make_scan_step(cam, cfg, device="cuda", whole: bool = True, graph: bool = True):
    """The whole per-frame step for ``cam``/``cfg`` as the scan calls it; with
    ``whole=False`` its tracking half (``make_track_step``).  On a CUDA device
    the step is captured in CUDA graphs (:class:`StepGraph`) unless ``graph``
    is False; on the CPU it is the eager step."""
    make = make_frame_step if whole else make_track_step
    step = make(
        cam, frame_grid(cam, cfg), cfg.klt_max_level, cfg.klt_min_level, cfg.coarse_n_iter,
        cfg.coarse_pattern_offset, cfg.poseoptim_thresh,
        n_obs_pad=obs_slots(cam, cfg), edgelet_cos_angle=cfg.edgelet_angle,
        align_max_iter=cfg.align_max_iter, patch_closest=(cfg.patch_source == "closest"),
        device=device)
    if graph and torch.device(device).type == "cuda":
        return StepGraph(step, device)
    return step


def is_keyframe(i: int) -> bool:
    return i % KF_EVERY == KF_EVERY - 1


def pin_float32_matmul() -> None:
    """Full float32 matmuls on the card (no TF32): the BA's Schur products and
    its host grouping are held to the JAX solver's float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def run_scan(step, carry, frames, cam, cfg, px_error_angle, on_frame=None):
    """Run ``frames`` (numpy images or tensors) through the scan from
    ``carry`` (as :func:`hso_tpu_torch.utils.checkpoint.scan_state_from_checkpoint`
    returns it); ``carry`` itself is left untouched.

    Returns a dict: ``traj`` (N, 3, 4) poses, ``chk`` the scalar sum of the
    per-frame check values (keyframe ``chk`` + seeds updated + matches + pose
    error), ``n_inliers`` (N,), ``carry`` the state after the last frame and
    ``kf_stats`` the keyframe work's statistics, one dict per event; all
    device tensors.  ``on_frame(i, keyframe, out, carry)``, when given, is
    called after each frame's work with the step's output and the new carry."""
    pin_float32_matmul()
    dev = carry["acc"].device
    T_rel = torch.eye(3, 4, dtype=torch.float32, device=dev)
    traj, chks, inliers, kf_stats = [], [], [], []
    for i, img in enumerate(frames):
        st = carry["st"]
        out = step(img, carry["pyr"], carry["grad_mean"], carry["T"], carry["obs"],
                   carry["intensity"], carry["exposure"], T_rel,
                   {k: st[k] for k in SNAP_FROM_ST}, carry["seeds"], px_error_angle,
                   carry["acc"])
        data = out["data"]
        seeds = out["seeds"]
        kf = is_keyframe(i)
        kf_chk = torch.zeros((), dtype=torch.float32, device=dev)
        if kf:
            st, seeds, kf_chk, stats = keyframe_work(st, seeds, out, cam, cfg)
            kf_stats.append(stats)
        chk = (kf_chk + out["n_seeds_updated"].to(torch.float32)
               + out["n_matches"].to(torch.float32) + out["err_px"])
        carry = dict(T=out["T_new"], pyr=data["pyr"], grad_mean=data["grad_mean"],
                     intensity=data["intensity_mean"], exposure=out["exposure"],
                     obs=out["obs_next"], seeds=seeds, acc=out["acc"], st=st)
        traj.append(out["T_new"].clone())
        chks.append(chk)
        inliers.append(out["n_inliers"].clone())
        if on_frame is not None:
            on_frame(i, kf, out, carry)
    return dict(traj=torch.stack(traj), chk=torch.sum(torch.stack(chks)),
                n_inliers=torch.stack(inliers), carry=carry, kf_stats=kf_stats)

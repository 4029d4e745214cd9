"""The evolving-map scan: the per-frame step over a sequence of frames, with
the keyframe work on a schedule the host knows.

At every frame ``run_scan`` runs the whole per-frame step
(:func:`hso_tpu_torch.pipeline.fused_step.make_frame_step`) against the map
state carried in ``st``; on the frames where ``i % KF_EVERY == KF_EVERY - 1``
(the schedule stays on the host, as the JAX bench's ``kf_sched`` is an input)
it then runs the keyframe body, :func:`hso_tpu_torch.pipeline.keyframe.keyframe_work`,
which mutates the map (BA write-back, activated seeds, new seeds).  The carry is
the pose, the pyramid and its statistics, the exposure, the tracking
reference (``obs``), the seed table, the point success/fail counters
(``acc``) and the map state ``st``.

On the card the step is a :class:`~hso_tpu_torch.pipeline.step_graph.StepGraph`
by default (``make_scan_step(..., graph=False)`` gives the eager step): a
frame is one graph replay and waits on nothing; the eager step waits for the
device at its FC/IC choice (and on an FC frame once an LM iteration).  The
keyframe body is the step's ``keyframe_body`` (:func:`make_keyframe_body`),
on the card also a ``StepGraph``: two captured graphs of the whole body (the
JAX bench's ``lax.cond`` around it, ``bench.py:533-534``) used in turns, one
replay an event, with the members of the step's output it reads
(:data:`KF_OUT_KEYS`, :data:`KF_DATA_KEYS`) staged into it.  Neither body
waits on the device.  A graph's outputs are overwritten two calls later: the
carry lives one frame (the map state one event), and the per-frame and
per-event records are copies.
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
#: the step outputs the keyframe body reads, and the members of ``out["data"]``
KF_OUT_KEYS = ("T_new", "exposure", "success", "inlier", "cid", "f_cur", "grad_cur", "species",
               "level", "px", "depth_mean", "depth_min")
KF_DATA_KEYS = ("pyr", "sobel_x", "sobel_y", "grad_mean")


def frame_grid(cam, cfg) -> tuple:
    """(cell, rows, cols) of the candidate-selection grid."""
    cell = max(int(np.sqrt(cam.width * cam.height / cfg.max_fts) * 0.8), 16)
    return (cell, -(-cam.height // cell), -(-cam.width // cell))


def obs_slots(cam, cfg) -> int:
    """Fixed slot count of the step's observation tables."""
    grid = frame_grid(cam, cfg)
    return max(cfg.n_fts_max, grid[1] * grid[2])


def keyframe_inputs(out) -> dict:
    """What the keyframe body reads of a step's output ``out``."""
    sub = {k: out[k] for k in KF_OUT_KEYS}
    sub["data"] = {k: out["data"][k] for k in KF_DATA_KEYS}
    return sub


def make_keyframe_body(cam, cfg, device="cuda", graph: bool = True):
    """The keyframe work for ``cam``/``cfg`` as the scan calls it,
    ``body(st, seeds, keyframe_inputs(out)) -> (st', seeds', chk, stats)``.
    On a CUDA device it is captured in CUDA graphs (a :class:`StepGraph`
    whose first argument is not an image) unless ``graph`` is False; on the
    CPU it is the eager body."""
    def body(st, seeds, kf_in):
        return keyframe_work(st, seeds, kf_in, cam, cfg)

    if graph and torch.device(device).type == "cuda":
        return StepGraph(body, device, image=False)
    return body


def make_scan_step(cam, cfg, device="cuda", whole: bool = True, graph: bool = True):
    """The whole per-frame step for ``cam``/``cfg`` as the scan calls it; with
    ``whole=False`` its tracking half (``make_track_step``).  On a CUDA device
    the step is captured in CUDA graphs (:class:`StepGraph`) unless ``graph``
    is False; on the CPU it is the eager step.  The whole step carries the
    scan's keyframe body as its attribute ``keyframe_body``
    (:func:`make_keyframe_body` with the same ``graph``), built once with it
    so that every run of the scan reuses the body's captures."""
    make = make_frame_step if whole else make_track_step
    step = make(
        cam, frame_grid(cam, cfg), cfg.klt_max_level, cfg.klt_min_level, cfg.coarse_n_iter,
        cfg.coarse_pattern_offset, cfg.poseoptim_thresh,
        n_obs_pad=obs_slots(cam, cfg), edgelet_cos_angle=cfg.edgelet_angle,
        align_max_iter=cfg.align_max_iter, patch_closest=(cfg.patch_source == "closest"),
        device=device)
    if graph and torch.device(device).type == "cuda":
        step = StepGraph(step, device)
    if whole:
        step.keyframe_body = make_keyframe_body(cam, cfg, device, graph)
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
    called after each frame's work with the step's output and the new carry.
    The keyframe body is ``step.keyframe_body``; a step without one (a step
    made elsewhere) gets the eager body."""
    pin_float32_matmul()
    dev = carry["acc"].device
    body = getattr(step, "keyframe_body", None)
    if body is None:
        body = make_keyframe_body(cam, cfg, dev, graph=False)
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
            st, seeds, kf_chk, stats = body(st, seeds, keyframe_inputs(out))
            kf_stats.append({k: v.clone() for k, v in stats.items()})
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

"""The plain reference that decides ``correct``: the scene's own geometry.

Every answer the handler gives is judged against what the benchmark made the
frames from, worked out again here with plain PyTorch and numpy (the ray cast
of ``vobench.scene``, the alignment of ``vobench.evaluate``); nothing the
program derived is read but the answers themselves:

* each frame's pose (the coarse tracker, the matcher and the pose LM): after
  one similarity alignment of all tracked frames to the rendered poses, the
  position and rotation error of every frame of the timed path;
* the map after the last keyframe event's BA (point inverse distances, written
  back by the solve): each point's distance against the true one along its
  bearing from its host keyframe's rendered pose;
* the depth filter's seed table after the last sweep: each seed that took
  updates, likewise, in the filter's own standard deviations (read and
  printed; no control moves it, so it is not compared).

The windowed-BA solves themselves are judged in ``vobench.reference.ba``.

Distances of the port are in its own monocular unit; the alignment's scale
turns them into metres.
"""

from __future__ import annotations

import numpy as np
import torch

from vobench.evaluate import align_errors


def true_distance(scene, T_c_w: np.ndarray, f_c: np.ndarray) -> np.ndarray:
    """Distance (m) from each camera ``T_c_w`` (N, 3, 4) along its bearing
    ``f_c`` (N, 3, camera frame) to the first surface of ``scene``."""
    dev = scene.device
    T = torch.from_numpy(np.ascontiguousarray(T_c_w, np.float64)).to(dev)
    f = torch.from_numpy(np.ascontiguousarray(f_c, np.float64)).to(dev)
    f = f / f.norm(dim=-1, keepdim=True)
    R, t = T[:, :, :3], T[:, :, 3]
    f_w = torch.einsum("nji,nj->ni", R, f)
    t_w = -torch.einsum("nji,nj->ni", R, t)
    lam, _ = scene.raycast(f_w, t_w)
    return lam.cpu().numpy()


def _p(x: np.ndarray, q: float) -> float:
    return float(np.percentile(x, q)) if len(x) else float("nan")


def judge(scene, gt: np.ndarray, est: np.ndarray, tracked: np.ndarray, timed: np.ndarray,
          points: dict, seeds: dict) -> dict:
    """The numbers compared, from the rendered poses ``gt`` and the handler's
    ``est`` (both (N, 3, 4) world→camera, one a frame of the run), the frames
    ``tracked`` (mask: the alignment's frames) and ``timed`` (mask: the frames
    judged), and the map's ``points`` and ``seeds`` (host frame index,
    bearing, inverse distance; seeds also their standard deviation)."""
    al = align_errors(est, gt, tracked)
    s = al["scale"]
    out = dict(
        ate_rmse_mm=1e3 * float(np.sqrt(np.mean(al["pos_m"][timed] ** 2))),
        pos_err_max_mm=1e3 * float(np.max(al["pos_m"][timed])),
        rot_err_max_deg=float(np.max(al["rot_deg"][timed])),
        scale=s,
    )
    for name, tab in (("point", points), ("seed", seeds)):
        n = len(tab["frame"])
        if n == 0:
            out[f"{name}_n"] = 0
            continue
        d_true = true_distance(scene, gt[tab["frame"]], tab["f"])
        ok = np.isfinite(d_true) & (tab["idist"] > 1e-9)
        rel = np.abs(s / np.where(ok, tab["idist"], 1.0) / np.where(ok, d_true, 1.0) - 1.0)[ok]
        out[f"{name}_n"] = int(ok.sum())
        out[f"{name}_depth_err_p50"] = _p(rel, 50)
        if "sigma" in tab:
            # the filter's own uncertainty: how many of its sigmas the truth lies away
            z = np.abs(tab["idist"] - s / np.where(ok, d_true, 1.0)) / np.maximum(tab["sigma"],
                                                                                1e-12)
            out[f"{name}_z_p50"] = _p(z[ok], 50)
    return out

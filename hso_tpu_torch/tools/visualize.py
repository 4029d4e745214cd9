"""Offline map and trajectory view from a checkpoint or a trajectory file.

The port's counterpart of the JAX package's ``scripts/visualize.py``, drawn
with numpy (no matplotlib) and written with the port's own PNG writer:

    python -m hso_tpu_torch.tools.visualize checkpoint=<map.npz> [out=<prefix>]
    python -m hso_tpu_torch.tools.visualize traj=<KeyFrameTrajectory.txt> [out=<prefix>]

Writes

    <prefix>.png   two panels, top-down (x–z) and side (x–y), each scaled to
                   the data's extent: map points grey by their host window's
                   centre intensity, the trajectory in red, keyframe centres
                   as blue squares;
    <prefix>.ply   map points (grey) and keyframe centres (red) as an ASCII
                   point cloud for any 3-D viewer.

A checkpoint is the ``.npz`` of ``utils/checkpoint.save_checkpoint`` (the
JAX package's format); a trajectory file is TUM's ``stamp tx ty tz qx qy qz
qw``.  Runs on the host only.
"""

from __future__ import annotations

import sys

import numpy as np

from hso_tpu_torch.io.image_reader import write_png
from hso_tpu_torch.math import se3np
from hso_tpu_torch.utils.live_view import draw_text

PANEL = 600                  #: each panel is PANEL × PANEL pixels
MARGIN = 24                  #: pixels between the data's extent and a panel's border
RED, BLUE, BLACK = (214, 39, 40), (31, 119, 180), (0, 0, 0)
#: (first axis, second axis, title) of the two panels
VIEWS = ((0, 2, "top-down x-z"), (0, 1, "side x-y"))


def load_checkpoint(path: str):
    """(world points (M, 3), their intensities (M,), keyframe centres (K, 3))
    of a checkpoint's valid map points."""
    z = np.load(path, allow_pickle=False)
    valid = z["pt_valid"]
    T_h = z["kf_poses"][z["pt_host_kf"]]
    p_h = z["pt_host_f"].astype(np.float64) / np.maximum(z["pt_idist"], 1e-10)[:, None]
    pts = se3np.apply(se3np.inv(T_h), p_h)[valid]
    win = z["pt_host_win"][valid]
    inten = win[:, win.shape[1] // 2, win.shape[2] // 2]
    n_kf = int(z["kf_count"])
    centers = (np.stack([se3np.translation(se3np.inv(z[f"kf{i}_T"])) for i in range(n_kf)])
               if n_kf else np.zeros((0, 3)))
    return pts, inten, centers


def load_traj(path: str) -> np.ndarray:
    """Positions (N, 3) of a TUM trajectory file."""
    rows = np.loadtxt(path)
    if rows.ndim == 1:
        rows = rows[None]
    return rows[:, 1:4]


def write_ply(path: str, pts, inten, centers) -> None:
    n = len(pts) + len(centers)
    with open(path, "w") as fh:
        fh.write("ply\nformat ascii 1.0\n"
                 f"element vertex {n}\n"
                 "property float x\nproperty float y\nproperty float z\n"
                 "property uchar red\nproperty uchar green\nproperty uchar blue\n"
                 "end_header\n")
        for p, c in zip(pts, inten):
            g = int(np.clip(c, 0, 255))
            fh.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {g} {g} {g}\n")
        for p in centers:
            fh.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} 220 40 40\n")


def panel(pts, inten, traj, centers, i: int, j: int, title: str) -> np.ndarray:
    """One view (axes ``i``, ``j``) as a PANEL × PANEL RGB image."""
    vis = np.full((PANEL, PANEL, 3), 255, np.uint8)
    allp = np.concatenate([pts, traj, centers])[:, [i, j]]
    allp = allp[np.isfinite(allp).all(axis=1)]
    lo = allp.min(0) if len(allp) else np.zeros(2)
    span = float(max(np.ptp(allp, axis=0).max() if len(allp) else 1.0, 1e-6))
    s = (PANEL - 1 - 2 * MARGIN) / span

    def pix(p):
        u = np.floor(MARGIN + (p[:, i] - lo[0]) * s).astype(np.int64)
        v = np.floor(PANEL - 1 - MARGIN - (p[:, j] - lo[1]) * s).astype(np.int64)
        return u, v

    def put(p, color, radius=0):
        if not len(p):
            return
        u, v = pix(p)
        color = np.asarray(color, np.uint8).reshape(-1, 3)
        for dv in range(-radius, radius + 1):
            for du in range(-radius, radius + 1):
                uu, vv = u + du, v + dv
                ok = (uu >= 0) & (uu < PANEL) & (vv >= 0) & (vv < PANEL)
                vis[vv[ok], uu[ok]] = color[ok] if len(color) > 1 else color[0]

    grey = np.clip(np.asarray(inten, np.float64), 0, 255).astype(np.uint8)
    put(pts, np.repeat(grey[:, None], 3, axis=1))
    for a, b in zip(traj[:-1], traj[1:]):              # the trajectory, one pixel a step
        n = int(np.ceil(np.hypot(b[i] - a[i], b[j] - a[j]) * s)) + 1
        t = np.linspace(0.0, 1.0, n)[:, None]
        put(a[None] + t * (b - a)[None], RED)
    put(centers, BLUE, radius=2)
    draw_text(vis, title, (8, 8), BLACK)
    return vis


def render(pts, inten, traj, centers) -> np.ndarray:
    """The two panels side by side."""
    return np.concatenate([panel(pts, inten, traj, centers, i, j, title)
                           for i, j, title in VIEWS], axis=1)


def main(argv=None) -> int:
    args = dict(a.split("=", 1) for a in (sys.argv[1:] if argv is None else argv) if "=" in a)
    if "checkpoint" not in args and "traj" not in args:
        print(__doc__)
        return 1
    out = args.get("out", "map_view")
    pts, inten, centers = np.zeros((0, 3)), np.zeros((0,)), np.zeros((0, 3))
    if "checkpoint" in args:
        pts, inten, centers = load_checkpoint(args["checkpoint"])
    traj = load_traj(args["traj"]) if "traj" in args else centers
    write_png(out + ".png", render(pts, inten, traj, centers))
    print(f"wrote {out}.png")
    if len(pts) or len(centers):
        write_ply(out + ".ply", pts, inten, centers)
        print(f"wrote {out}.ply ({len(pts)} points, {len(centers)} keyframes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

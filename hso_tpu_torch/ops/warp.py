"""Batched affine patch warping between views.

``warp_matrices`` / ``best_search_level`` / ``warp_from_stored_windows`` for
all match candidates at once.  The warped 10×10 reference patches are
sampled from each candidate's memoized host window by 4-tap bilinear
gathers (:func:`hso_tpu_torch.ops.gatherless.bilinear_scatter_in_windows`).
``memoize_level_windows`` extracts those host windows once, at point or
seed creation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hso_tpu_torch.math.linalg_small import det2x2
from hso_tpu_torch.ops.epipolar import pack_level_windows
from hso_tpu_torch.ops.gatherless import bilinear_scatter_in_windows

BORD = 10          # bordered patch edge (patch 8 + 1px border)
HALF_BORD = 5


def _pow2(level: torch.Tensor) -> torch.Tensor:
    """2**level for an integer tensor, as float32 (exact)."""
    return torch.bitwise_left_shift(torch.ones_like(level), level).to(torch.float32)


def warp_matrices(cam_ref, cam_cur, px_ref, f_ref, depth_ref, T_cur_ref, level_ref):
    """A_cur_ref (N, 2, 2): local affine px_cur ≈ A · px_ref around the
    feature (finite differences of half-patch size 5 along the ref axes at
    the feature's pyramid level).  Returns (A_cur_ref, px_cur)."""
    ratio = _pow2(level_ref) if isinstance(level_ref, torch.Tensor) else float(1 << level_ref)
    half = 5.0
    xyz_ref = f_ref * depth_ref[:, None]
    du = torch.stack([px_ref[:, 0] + half * ratio, px_ref[:, 1]], dim=-1)
    dv = torch.stack([px_ref[:, 0], px_ref[:, 1] + half * ratio], dim=-1)
    f_du = cam_ref.cam2world(du)
    f_dv = cam_ref.cam2world(dv)
    z = xyz_ref[:, 2:3]
    xyz_du = f_du * (z / f_du[:, 2:3])
    xyz_dv = f_dv * (z / f_dv[:, 2:3])

    def proj(p):
        R = T_cur_ref[..., :3, :3]
        t = T_cur_ref[..., :3, 3]
        return cam_cur.world2cam(torch.sum(R * p[:, None, :], dim=-1) + t)

    px_cur = proj(xyz_ref)
    col0 = (proj(xyz_du) - px_cur) / half
    col1 = (proj(xyz_dv) - px_cur) / half
    return torch.stack([col0, col1], dim=-1), px_cur


def best_search_level(A_cur_ref: torch.Tensor, max_level: int) -> torch.Tensor:
    """Per-candidate search pyramid level: quarter the warp determinant
    until ≤ 3."""
    D = torch.abs(det2x2(A_cur_ref))
    level = torch.zeros(D.shape, dtype=torch.int32, device=D.device)
    for k in range(max_level):
        level = level + (D * (0.25 ** k) > 3.0).to(torch.int32)
    return level


def _box_blur_window(win: torch.Tensor, k: int) -> torch.Tensor:
    """k×k box average of (N, W, W) windows, top-left anchored (same size,
    edge-replicated): b[y, x] = mean win[y:y+k, x:x+k] — the filter a pyramid
    level ``log2(k)`` applies before subsampling."""
    w = win.shape[-1]
    p = F.pad(win[:, None], (0, k - 1, 0, k - 1), mode="replicate")[:, 0]
    acc = torch.zeros_like(win)
    for dy in range(k):
        for dx in range(k):
            acc = acc + p[:, dy: dy + w, dx: dx + w]
    return acc / float(k * k)


def warp_from_stored_windows(host_win, host_anchor, px_host, host_level, A_ref_cur,
                             search_level, max_mip_delta: int = 2):
    """Warped 10×10 bordered reference patches sampled from memoized host
    windows (no host-image access).  ``px_host`` are level-0 coords;
    ``host_level`` (N,) the level the window was extracted at.

    When the search runs coarser than the host level, the grid points land
    2^Δ px apart in the stored window; point-sampling the fine texture there
    would alias against the box-filtered current pyramid level.  The window
    is therefore box-blurred by 2^Δ (Δ = search − host level, clipped)
    before sampling: a masked select over ``max_mip_delta``+1 blurs."""
    n = host_win.shape[0]
    dev = host_win.device
    g = torch.arange(BORD, dtype=torch.float32, device=dev) - HALF_BORD
    gy, gx = torch.meshgrid(g, g, indexing="ij")
    pts = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=0)          # (2, 100)
    scale_s = (2.0 ** search_level.to(torch.float32))[:, None, None]
    src = torch.sum(A_ref_cur[..., :, :, None] * pts[None, None, :, :], dim=-2) * scale_s
    lvl_scale = 1.0 / _pow2(host_level)
    anchor_f = host_anchor.to(torch.float32)
    hu = src[:, 0, :] + (px_host[:, 0] * lvl_scale - anchor_f[:, 0])[:, None]
    hv = src[:, 1, :] + (px_host[:, 1] * lvl_scale - anchor_f[:, 1])[:, None]

    delta = torch.clamp(search_level - host_level, 0, max_mip_delta)
    win_sel = host_win
    for d in range(1, max_mip_delta + 1):
        win_sel = torch.where((delta == d)[:, None, None],
                              _box_blur_window(host_win, 1 << d), win_sel)
    return bilinear_scatter_in_windows(win_sel, hu, hv).reshape(n, BORD, BORD)


def memoize_level_windows(pyr, px, level, win: int = 24, n_levels: int = 3):
    """Extract a (win × win) appearance window per row from its own pyramid
    level (one call at point/seed creation or patch-source refresh, then
    matching never reads this pyramid again).  ``px`` is in level-0
    coordinates.  Returns (windows (N, win, win), anchors (N, 2) int32 in
    level coordinates); a row whose level lies outside [0, n_levels) gets a
    zero window at anchor (0, 0).  One per-row-level gather (kernel K2 on the
    card): ``px · 2^-level`` is exact, so the anchors are those of one
    extraction per level."""
    level = level.to(torch.int32)
    scale = 1.0 / _pow2(level.clamp(0, n_levels - 1))
    windows, (au, av), _ = pack_level_windows(pyr, level, px[:, 0] * scale, px[:, 1] * scale,
                                              win, n_levels)
    return windows, torch.stack([au, av], dim=-1)


def memoize_level_windows_packed(pyr, px, level, win: int = 24, n_levels: int = 3):
    """:func:`memoize_level_windows` with windows and anchors flattened into
    ONE (N, win·win+2) buffer: a single device→host copy."""
    w, a = memoize_level_windows(pyr, px, level, win=win, n_levels=n_levels)
    n = w.shape[0]
    return torch.cat([w.reshape(n, -1), a.to(torch.float32)], dim=-1)

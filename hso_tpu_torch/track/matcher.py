"""Batched direct matching of map points into the current frame.

For every candidate point at once: affine warp of its memoized host patch,
search-level selection, exposure compensation, inverse-compositional
alignment (2D for corners, along-normal 1D for edgelets), NCC and
edgelet-normal acceptance gates, 20 px displacement cap.  Each point
carries one memoized patch-source view, which the pipeline passes as the
``host_*`` candidate rows.
"""

from __future__ import annotations

import torch

from hso_tpu_torch.math import se3
from hso_tpu_torch.math.linalg_small import inv2x2
from hso_tpu_torch.ops.align_cuda import (ROW_CONV, ROW_GX, ROW_GY, ROW_NCC, ROW_U, ROW_V,
                                          align_match)
from hso_tpu_torch.ops.epipolar import pack_level_windows
from hso_tpu_torch.ops.warp import best_search_level, warp_from_stored_windows, warp_matrices

EDGELET = 1
WIN = 24


def match_points(cand, cur_pyr, cur_sobel_x, cur_sobel_y, T_cur_w, exposure_cur, cam,
                 n_levels: int = 3, edgelet_cos_angle: float = 0.86,
                 align_max_iter: int = 10):
    """``cand`` is a dict of candidate rows: host_win, host_anchor, host_px,
    host_f, host_level, grad, species, idist, T_host_w (N,3,4),
    exposure_host (N,), valid (N,).  ``cur_sobel_x/y`` are accepted for
    signature parity and not read (the gradient direction is sampled from
    the packed windows).

    Returns dict(px (N,2) level-0, level (N,), f_cur (N,3), success (N,),
    grad_cur (N,2))."""
    T_c_h = se3.mul(T_cur_w.expand(cand["T_host_w"].shape), se3.inv(cand["T_host_w"]))
    depth_host = 1.0 / torch.clamp_min(cand["idist"], 1e-10)

    A_cur_ref, px_proj = warp_matrices(
        cam, cam, cand["host_px"], cand["host_f"], depth_host, T_c_h, cand["host_level"])
    search_level = torch.clamp(best_search_level(A_cur_ref, n_levels - 1), 0, n_levels - 1)

    A_ref_cur = inv2x2(A_cur_ref)
    A_ref_cur = torch.where(torch.isfinite(A_ref_cur), A_ref_cur, torch.zeros_like(A_ref_cur))

    ref_border = warp_from_stored_windows(
        cand["host_win"], cand["host_anchor"], cand["host_px"],
        cand["host_level"], A_ref_cur, search_level)
    exp_ratio = exposure_cur / torch.clamp_min(cand["exposure_host"], 1e-6)
    ref_border = ref_border * exp_ratio[:, None, None]

    grad_cur = torch.sum(A_cur_ref * cand["grad"][:, None, :], dim=-1)
    grad_cur = grad_cur / torch.clamp_min(
        torch.linalg.norm(grad_cur, dim=-1, keepdim=True), 1e-9)
    is_edge = cand["species"] == EDGELET

    valid0 = cand["valid"] & cam.is_in_frame(px_proj, border=8)

    # level-packed windows: one alignment pass for all candidates
    level_scale = 2.0 ** search_level.to(torch.float32)
    px_init = px_proj / level_scale[:, None]
    windows, anchors, img_hw = pack_level_windows(
        cur_pyr, search_level, px_init[:, 0], px_init[:, 1], WIN, n_levels)

    out8 = align_match(is_edge, grad_cur, ref_border, px_init, valid0, windows,
                       anchors[0], anchors[1], img_hw[0], img_hw[1],
                       win=WIN, n_iter=align_max_iter)
    px_l = torch.stack([out8[ROW_U], out8[ROW_V]], dim=-1)
    conv = out8[ROW_CONV] > 0.5
    score = out8[ROW_NCC]

    disp_ok = torch.linalg.norm(px_l - px_init, dim=-1) < 20.0
    gn = torch.stack([out8[ROW_GX], out8[ROW_GY]], dim=-1)
    gn = gn / torch.clamp_min(torch.linalg.norm(gn, dim=-1, keepdim=True), 1e-9)
    normal_ok = torch.where(is_edge, torch.sum(grad_cur * gn, dim=-1) > edgelet_cos_angle,
                            torch.ones_like(is_edge))

    success = valid0 & conv & (score > 0.7) & disp_ok & normal_ok
    px_out = torch.where(success[:, None], px_l * level_scale[:, None],
                         torch.zeros_like(px_l))
    f_cur = cam.cam2world(px_out)
    return {
        "px": px_out,
        "level": search_level,
        "f_cur": f_cur.to(torch.float32),
        "success": success,
        "grad_cur": grad_cur,
    }


def select_candidates(pos_w, valid, priority, T_cur_w, cam, cell: int = 36,
                      grid_h: int = 14, grid_w: int = 21, n_types: int = 8):
    """Grid-based candidate selection: project all live points, keep the
    best-priority point per grid cell and its runner-up.

    The per-cell maximum is a ``scatter_reduce_(amax)`` over the key
    ``priority * P + index``; the key is unique per point, so the result
    does not depend on the order in which the scatter visits the points.

    Returns dict(cell_point, cell_valid, cell_px, cell_point2, cell_valid2,
    cell_px2, n_projected) with C = grid_h * grid_w rows.
    """
    p = pos_w.shape[0]
    dev = pos_w.device
    p_cur = se3.apply(T_cur_w, pos_w)
    px = cam.world2cam(p_cur)
    ok = valid & (p_cur[:, 2] > 0.0) & cam.is_in_frame(px, border=8)

    def cell_of(x, hi):
        c = torch.div(x, float(cell), rounding_mode="floor")
        # clamp in float first: the cast of a non-finite value is undefined
        return torch.nan_to_num(c, nan=0.0).clamp(0, hi).to(torch.int64)

    cidx = cell_of(px[:, 1], grid_h - 1) * grid_w + cell_of(px[:, 0], grid_w - 1)
    n_cells = grid_h * grid_w

    key = priority.to(torch.int64) * p + torch.arange(p, dtype=torch.int64, device=dev)
    key = torch.where(ok, key, torch.full_like(key, -1))

    def cell_max(k):
        best = torch.full((n_cells,), -1, dtype=torch.int64, device=dev)
        return best.scatter_reduce_(0, cidx, k, reduce="amax", include_self=True)

    best = cell_max(key)
    cell_valid = best >= 0
    cell_point = torch.where(cell_valid, best % p, torch.zeros_like(best))
    # runner-up per cell: the retry pass matches it when the best fails
    best2 = cell_max(torch.where(key == best[cidx], torch.full_like(key, -1), key))
    cell_valid2 = best2 >= 0
    cell_point2 = torch.where(cell_valid2, best2 % p, torch.zeros_like(best2))
    return {
        "cell_point": cell_point.to(torch.int32),
        "cell_valid": cell_valid,
        "cell_px": px[cell_point],
        "cell_point2": cell_point2.to(torch.int32),
        "cell_valid2": cell_valid2,
        "cell_px2": px[cell_point2],
        "n_projected": torch.sum(ok.to(torch.int32)),
    }

"""Batched epipolar line stereo via dense ZMNCC score maps.

All seeds are searched at once:

1. one *level-packed* window per seed covering its (cropped) epipolar
   segment — seeds searching at different pyramid levels share one buffer
   (:func:`pack_level_windows`), so every later step runs once, not once per
   level;
2. the zero-mean NCC of the warped reference patch at EVERY patch position of
   the window, sampled along the epipolar line with two-tap weights, and the
   best / second-best reduction: the device kernel behind
   :func:`hso_tpu_torch.ops.epipolar_cuda.zmncc_line_scores`;
3. the adjacency-aware ambiguity rejection (ratio 1.5) and the best pixel.

The search range is cropped to the window (``MAX_EPL`` px at the search
level); uncertain seeds take another frame or two to converge.  Sub-pixel
refinement afterwards is the batched alignment of ``ops/align_cuda.py``,
reusing the same windows.
"""

from __future__ import annotations

import torch

from hso_tpu_torch.ops.epipolar_cuda import zmncc_line_scores
from hso_tpu_torch.ops.gatherless import clip_anchor
from hso_tpu_torch.ops.window_cuda import pack_level_windows_gather

PATCH = 8
EW = 40                          #: per-seed search window edge
MAX_EPL = float(EW - PATCH - 4)  #: max epipolar length representable in a window
MIN_EPL = 2.0
AMBIGUITY_RATIO = 1.5            #: best must beat 1.5 × the far second-best


def pack_level_windows(pyr, search_level, center_u_l, center_v_l, win: int, n_levels: int):
    """Per-row windows from per-row pyramid levels, merged into one buffer.

    ``center_u_l/v_l`` are centres in each row's OWN level coordinates.
    Returns (windows (S, win, win), (au, av), (h_l, w_l) per-row image dims).
    """
    s = search_level.shape[0]
    dev = search_level.device
    au = torch.zeros((s,), dtype=torch.int32, device=dev)
    av = torch.zeros((s,), dtype=torch.int32, device=dev)
    hs = torch.zeros((s,), dtype=torch.int32, device=dev)
    ws = torch.zeros((s,), dtype=torch.int32, device=dev)
    for lvl in range(n_levels):
        h, w = pyr[lvl].shape
        a_u, a_v = clip_anchor(center_u_l, center_v_l, win, 0, h, w)
        sel = search_level == lvl
        au = torch.where(sel, a_u, au)
        av = torch.where(sel, a_v, av)
        hs = torch.where(sel, torch.full_like(hs, h), hs)
        ws = torch.where(sel, torch.full_like(ws, w), ws)
    windows = pack_level_windows_gather(pyr, search_level, au, av, win, n_levels)
    return windows, (au, av), (hs, ws)


def epipolar_zmncc_search(windows, anchors, img_hw, ref_patch, px_far, px_close, valid,
                          n_steps: int = 40):
    """Dense ZMNCC search along each epipolar segment.

    ``windows`` (S, EW, EW) level-packed search windows, ``anchors`` (au, av)
    in level coordinates, ``img_hw`` (h_l, w_l) per-seed image dims at the
    search level, ``ref_patch`` (S, 8, 8) warped and exposure-compensated
    templates, ``px_far``/``px_close`` (S, 2) the segment's ends (far-depth
    and close-depth projection) in level coordinates, ``valid`` (S,).

    Returns dict(px_best (S,2), score_best, score_second, ok (S,),
    n_line (S,), epl_dir (S,2))."""
    au, av = anchors
    hs, ws = img_hw

    d = px_close - px_far
    epl_len = torch.linalg.norm(d, dim=-1)
    dir_unit = d / torch.clamp_min(epl_len, 1e-9)[:, None]

    # crop long segments toward the far end, pad short ones symmetrically to
    # MIN_EPL (+1 sample each side)
    length = torch.clamp(epl_len, 0.0, MAX_EPL)
    pad = torch.clamp_min((MIN_EPL - length) * 0.5, 0.0)
    start = px_far - dir_unit * (1.0 + pad)[:, None]
    n_line = torch.ceil(length + 2.0 * (1.0 + pad))
    # clamp in float first: the cast of a non-finite value is undefined (such
    # rows are masked by the caller; NaN counts as 0 steps)
    n_line = torch.nan_to_num(n_line, nan=0.0).clamp(0.0, float(n_steps - 1)).to(torch.int32)

    su0 = start[:, 0] - 4.0 - au.to(torch.float32)
    sv0 = start[:, 1] - 4.0 - av.to(torch.float32)
    score_best, score_second, k_best = zmncc_line_scores(
        windows, ref_patch, su0, sv0, dir_unit[:, 0], dir_unit[:, 1], n_line,
        au, av, hs, ws, n_steps)

    ambiguous = (score_second > float("-inf")) & (AMBIGUITY_RATIO * score_second > score_best)
    ok = valid & torch.isfinite(score_best) & (score_best > 0.1) & ~ambiguous

    kf = k_best.to(torch.float32)
    px_best = torch.stack([start[:, 0] + dir_unit[:, 0] * kf,
                           start[:, 1] + dir_unit[:, 1] * kf], dim=-1)
    return {
        "px_best": px_best,
        "score_best": score_best,
        "score_second": score_second,
        "ok": ok,
        "n_line": n_line,
        "epl_dir": dir_unit,
    }


def triangulate_depth(T_cur_ref, f_ref, f_cur):
    """Batched midpoint depth along ``f_ref``: solves
    min ‖[R f_ref, f_cur] λ + t‖.  Returns (depth, ok)."""
    R = T_cur_ref[..., :3, :3]
    t = T_cur_ref[..., :3, 3]
    a0 = torch.sum(R * f_ref[:, None, :], dim=-1)
    A = torch.stack([a0, f_cur], dim=-1)                          # (N, 3, 2)
    AtA = torch.sum(A[..., :, None] * A[..., None, :], dim=1)
    det = AtA[:, 0, 0] * AtA[:, 1, 1] - AtA[:, 0, 1] * AtA[:, 1, 0]
    ok = torch.abs(det) > 1e-6
    det_safe = torch.where(ok, det, torch.ones_like(det))
    inv = torch.stack([
        torch.stack([AtA[:, 1, 1], -AtA[:, 0, 1]], dim=-1),
        torch.stack([-AtA[:, 1, 0], AtA[:, 0, 0]], dim=-1),
    ], dim=-2) / det_safe[:, None, None]
    Atb = -torch.sum(A * t[..., None], dim=1)
    lam = torch.sum(inv * Atb[:, None, :], dim=-1)
    return torch.abs(lam[:, 0]), ok

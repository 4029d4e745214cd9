"""Coarse tracker: direct sparse image alignment with joint exposure ratio.

Levenberg-Marquardt over a 7-DoF state [exposure_ratio; se3] with per-level
MAD robust thresholds, DSO saturation energy, and forward- or
inverse-compositional updates chosen per frame.

Per pyramid level one window extraction pulls a 24×24 window per feature
around its reference position and around its predicted projection (one
two-job launch of kernel K1 on the card); every LM
evaluation then samples its pattern constellation inside those windows.
The IC level loop is one fused kernel on the card (K3,
:mod:`hso_tpu_torch.track.coarse_cuda`) for every camera whose projection
:func:`~hso_tpu_torch.cameras.projection_model` names (the ideal pinhole,
radial-tangential, FOV), projecting through the camera's model; the FC
variant, and a camera of another model, run the same loop in plain PyTorch on
either device.
"""

from __future__ import annotations

import torch

from hso_tpu_torch.cameras import projection_model
from hso_tpu_torch.math import se3
from hso_tpu_torch.math.robust import masked_mad_sigma, masked_median
from hso_tpu_torch.ops.gatherless import clip_anchor, grid_in_window
from hso_tpu_torch.ops.patterns import PATTERN_PADDING, PATTERNS
from hso_tpu_torch.ops.window_cuda import extract_windows_multi
from hso_tpu_torch.track.coarse_cuda import (coarse_level_ic, lm_level_loop, pattern_samples,
                                             robust_system)

WIN = 24  # per-feature window size (all levels)


def _jacobian_uv_xi(xyz: torch.Tensor) -> torch.Tensor:
    """d(unit-plane uv)/d(xi) under the update convention T ← exp(-step)·T.
    xyz (N, 3) → (N, 2, 6), tangent ordering [rho, phi]."""
    x, y = xyz[:, 0], xyz[:, 1]
    z = xyz[:, 2]
    zi = 1.0 / torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
    zi2 = zi * zi
    zero = torch.zeros_like(x)
    row0 = torch.stack([-zi, zero, x * zi2, x * y * zi2, -(1.0 + x * x * zi2), y * zi], dim=-1)
    row1 = torch.stack([zero, -zi, y * zi2, 1.0 + y * y * zi2, -x * y * zi2, -x * zi], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def make_coarse_tracker(cam, max_level: int = 4, min_level: int = 1, n_iter: int = 30,
                        inverse: bool = False, pattern_offset: int = 2, device="cuda"):
    """Build the tracking function for a fixed camera/level config.

    Returned callable:
      ``track(ref_pyr, cur_pyr, px_ref, f_ref, dist_ref, T_cur_ref, a_init)``
        ref_pyr/cur_pyr : tuples of float32 pyramid images, level 0 first
        px_ref  (N, 2)  : level-0 feature pixels in the ref frame
        f_ref   (N, 3)  : unit bearings
        dist_ref (N,)   : distance along bearing (<= 0 marks an invalid slot)
        T_cur_ref (3,4) : initial relative pose guess
        a_init          : initial exposure ratio (cur_mean / ref_mean)
      → dict(T_cur_ref, exposure_ratio, n_tracked, energy, n_iters)
    Inputs may be numpy arrays or tensors; they are moved to ``device``.
    """
    device = torch.device(device)
    projection = projection_model(cam)
    fused = inverse and projection is not None

    def level_step(level, T, a, ref_img, cur_img, px_ref, f_ref, dist_ref):
        pat_idx = max_level - level + pattern_offset
        pattern = tuple(map(tuple, PATTERNS[pat_idx]))
        radius = PATTERN_PADDING[pat_idx]
        G = 2 * radius + 3          # pattern extent + 1 px gradient border
        c = radius + 1
        n_pat = len(pattern)
        scale = 1.0 / (1 << level)
        fxl = cam.fx * scale
        fyl = cam.fy * scale
        is_top = level == max_level
        border = radius + 1
        h, w = cur_img.shape
        hr, wr = ref_img.shape
        xyz_ref = f_ref * dist_ref[:, None]

        def project(T_e):
            xyz_cur = se3.apply(T_e, xyz_ref)
            uv0 = cam.world2cam(xyz_cur)
            return xyz_cur, uv0[:, 0] * scale, uv0[:, 1] * scale

        # ---- windows: reference side at the features, current side at the
        # incoming projection, both in one extraction ----
        u_r = px_ref[:, 0] * scale
        v_r = px_ref[:, 1] * scale
        vis = ((dist_ref > 0.0)
               & (torch.floor(u_r) - border >= 0) & (torch.floor(v_r) - border >= 0)
               & (torch.floor(u_r) + border < wr) & (torch.floor(v_r) + border < hr))
        au_r, av_r = clip_anchor(u_r, v_r, WIN, G, hr, wr)
        _, u_c0, v_c0 = project(T)
        au_c, av_c = clip_anchor(u_c0, v_c0, WIN, G, h, w)
        w_ref, w_cur = extract_windows_multi(
            [(ref_img, au_r, av_r), (cur_img, au_c, av_c)], WIN)

        # ---- reference side: patches (+ IC Jacobians), once ----
        ref_patch, rgx, rgy = pattern_samples(
            w_ref, u_r - c - au_r, v_r - c - av_r, c, pattern, with_grad=inverse)
        if inverse:
            Juv_r = _jacobian_uv_xi(xyz_ref)
            j_ic_raw = (rgx[..., None] * (fxl * Juv_r[:, None, 0, :])
                        + rgy[..., None] * (fyl * Juv_r[:, None, 1, :]))

        def evaluate(T_e, a_e, huber, cutoff):
            """(E_norm, H, b, n_terms) at state (T_e, a_e)."""
            xyz_cur, u, v = project(T_e)
            rel_u = u - c - au_c
            rel_v = v - c - av_c
            valid = (vis & (xyz_cur[:, 2] > 0.0) & grid_in_window(rel_u, rel_v, G, WIN)
                     & (torch.floor(u) - border >= 0) & (torch.floor(v) - border >= 0)
                     & (torch.floor(u) + border < w) & (torch.floor(v) + border < h))
            if inverse:
                cur_vals, _, _ = pattern_samples(w_cur, rel_u, rel_v, c, pattern, False)
                J_T = a_e * j_ic_raw
            else:
                cur_vals, cgx, cgy = pattern_samples(w_cur, rel_u, rel_v, c, pattern, True)
                Juv_c = _jacobian_uv_xi(xyz_cur)
                J_T = (cgx[..., None] * (fxl * Juv_c[:, None, 0, :])
                       + cgy[..., None] * (fyl * Juv_c[:, None, 1, :]))
            return robust_system(cur_vals, ref_patch, J_T, a_e, valid, huber, cutoff, is_top)

        # ---- robust thresholds from residuals at the initial state ----
        rel_u0 = u_c0 - c - au_c
        rel_v0 = v_c0 - c - av_c
        cur0, _, _ = pattern_samples(w_cur, rel_u0, rel_v0, c, pattern, False)
        valid0 = vis & grid_in_window(rel_u0, rel_v0, G, WIN)
        abs_r0 = torch.abs(cur0 - a * ref_patch).reshape(-1)
        m0 = valid0[:, None].expand(cur0.shape).reshape(-1)
        n0 = torch.sum(m0.to(torch.int32))
        med = masked_median(abs_r0, m0)
        sigma = masked_mad_sigma(abs_r0, m0)
        few = n0 < 30
        huber = torch.where(few, torch.full_like(med, 5.2), med + sigma)
        cutoff = torch.where(few, torch.full_like(med, 100.0),
                             torch.clamp_min(3.0 * (med + sigma), 10.0))

        if fused:
            T_f, a_f, energy, nt, iters = coarse_level_ic(
                w_cur, ref_patch, j_ic_raw, xyz_ref, au_c, av_c, vis, T, a, huber, cutoff,
                float(fxl), float(fyl), float(cam.cx * scale), float(cam.cy * scale),
                g=G, center=c, pattern=pattern, n_iter=n_iter, is_top=bool(is_top),
                border=int(border), h_img=int(h), w_img=int(w), projection=projection)
        else:
            T_f, a_f, energy, nt, iters = lm_level_loop(
                lambda T_e, a_e: evaluate(T_e, a_e, huber, cutoff), T, a, n_iter, inverse)
        return T_f, a_f, energy, torch.div(nt, n_pat, rounding_mode="floor"), iters

    def track(ref_pyr, cur_pyr, px_ref, f_ref, dist_ref, T_cur_ref, a_init):
        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32, device=device)

        T = f32(T_cur_ref)
        a = f32(a_init).reshape(())
        px_ref, f_ref, dist_ref = f32(px_ref), f32(f_ref), f32(dist_ref)
        energy = torch.zeros((), dtype=torch.float32, device=device)
        n_tracked = torch.zeros((), dtype=torch.int32, device=device)
        iters = []
        for level in range(max_level, min_level - 1, -1):
            T, a, energy, n_tracked, it = level_step(
                level, T, a, f32(ref_pyr[level]), f32(cur_pyr[level]),
                px_ref, f_ref, dist_ref)
            iters.append(it)
        return {
            "T_cur_ref": T,
            "exposure_ratio": a,
            "n_tracked": n_tracked,
            "energy": energy,
            "n_iters": torch.stack(iters),
        }

    return track

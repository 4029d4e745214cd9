"""Batched inverse-compositional KLT feature alignment (mixed 2D / 1D).

All candidates are aligned at once: (N, 8, 8) patch math, per-candidate
windows extracted once, every iteration a 4-tap bilinear sample inside the
window.  This module is the plain PyTorch formulation; the fused device
kernel and the dispatcher live in :mod:`hso_tpu_torch.ops.align_cuda`.
``align2d`` and ``align1d`` are the all-corner and all-edgelet cases of
``align_mixed`` (the pipeline uses only the mixed form).

Semantics:
  * 8×8 patches, 10×10 ref patch with border; template gradients by central
    differences on the bordered patch.
  * DSO-style gradient weights w = sqrt(250/(250+|∇T|²)).
  * 3-DoF state [u, v, mean_diff] for corners, 2-DoF [step-along-normal,
    mean_diff] for edgelets; inverse compositional — H from the template.
  * H diagonal inflated by 1.001; ``n_iter`` iterations; converge at
    |Δuv| < 0.03 px (2D) / |Δ| < 0.01 px (1D); fail if final chi2 > 1000·64
    or the patch leaves the image or its window.
"""

from __future__ import annotations

import torch

from hso_tpu_torch.math.linalg_small import inv2x2, inv3x3
from hso_tpu_torch.ops.gatherless import bilinear_grid, clip_anchor, extract_windows

PATCH = 8
BORD = PATCH + 2
WIN = 24
_HALF = PATCH // 2


def _template_grads(ref_border: torch.Tensor):
    """(N, 10, 10) bordered template → interior (N, 8, 8) value/dx/dy."""
    t = ref_border
    val = t[:, 1:-1, 1:-1]
    dx = 0.5 * (t[:, 1:-1, 2:] - t[:, 1:-1, :-2])
    dy = 0.5 * (t[:, 2:, 1:-1] - t[:, :-2, 1:-1])
    return val, dx, dy


def _sample(windows, au, av, u, v):
    """Sample the 8×8 patch at sub-pixel centre (u, v): grid point (x, y)
    maps to image coords (u - 4 + x, v - 4 + y)."""
    rel_u = (u - _HALF) - au
    rel_v = (v - _HALF) - av
    return bilinear_grid(windows, rel_u, rel_v, PATCH), rel_u, rel_v


def _in_image(u, v, h, w):
    ur = torch.floor(u)
    vr = torch.floor(v)
    return (ur >= _HALF) & (vr >= _HALF) & (ur < w - _HALF) & (vr < h - _HALF)


def _in_window(rel, extent):
    return (rel >= 0.0) & (rel + PATCH - 1 <= extent - 1.0)


def align_mixed(is_edge, direction, ref_border, px_init, n_iter: int = 10,
                valid=None, windows=None, anchors=None, img_hw=None):
    """Fused corner/edgelet alignment: one LM loop where corner rows take the
    3-DoF [u, v, mean] update and edgelet rows the 2-DoF [step-along-normal,
    mean] update; the per-iteration patch sampling is shared.

    All ``n_iter`` iterations run under the ``active`` mask (a candidate
    that converged or died keeps its state), so no iteration needs a host
    sync.  Returns dict(px, converged, chi2, cur_patch, mean_diff).
    """
    n = ref_border.shape[0]
    dev = ref_border.device
    h, w = img_hw
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=dev)
    ref, dx, dy = _template_grads(ref_border)
    ones = torch.ones_like(dx)

    # corner system (3-DoF)
    wgt2 = torch.sqrt(250.0 / (250.0 + dx * dx + dy * dy))
    j3 = torch.stack([dx, dy, ones], dim=-1)
    H3 = torch.sum(j3[..., :, None] * j3[..., None, :] * wgt2[..., None, None], dim=(1, 2))
    H3 = H3 * (torch.eye(3, device=dev) * 1e-3 + 1.0)
    Hinv3 = inv3x3(H3)

    # edgelet system (2-DoF along the normal)
    d = direction / torch.clamp_min(torch.linalg.norm(direction, dim=-1, keepdim=True), 1e-9)
    jd = dx * d[:, None, None, 0] + dy * d[:, None, None, 1]
    wgt1 = torch.sqrt(250.0 / (250.0 + jd * jd))
    j2 = torch.stack([jd, ones], dim=-1)
    H2 = torch.sum(j2[..., :, None] * j2[..., None, :] * wgt1[..., None, None], dim=(1, 2))
    H2 = H2 * (torch.eye(2, device=dev) * 1e-3 + 1.0)
    Hinv2 = inv2x2(H2)

    au, av = anchors
    au = au.to(torch.float32)
    av = av.to(torch.float32)
    win_n = windows.shape[1]
    wgt = torch.where(is_edge[:, None, None], wgt1, wgt2)

    u = px_init[:, 0]
    v = px_init[:, 1]
    mean_diff = torch.zeros((n,), dtype=torch.float32, device=dev)
    chi2 = torch.zeros((n,), dtype=torch.float32, device=dev)
    active = valid
    conv = torch.zeros((n,), dtype=torch.bool, device=dev)

    for _ in range(n_iter):
        patch, rel_u, rel_v = _sample(windows, au, av, u, v)
        inb = _in_image(u, v, h, w) & _in_window(rel_u, win_n) & _in_window(rel_v, win_n)
        active = active & inb & torch.isfinite(u) & torch.isfinite(v)

        res = patch - ref + mean_diff[:, None, None]
        new_chi2 = torch.sum(res * res * wgt, dim=(1, 2))
        jres3 = -torch.sum((res * wgt2)[..., None] * j3, dim=(1, 2))
        jres2 = -torch.sum((res * wgt1)[..., None] * j2, dim=(1, 2))
        upd3 = torch.sum(Hinv3 * jres3[:, None, :], dim=-1)
        upd2 = torch.sum(Hinv2 * jres2[:, None, :], dim=-1)

        du = torch.where(is_edge, upd2[:, 0] * d[:, 0], upd3[:, 0])
        dv = torch.where(is_edge, upd2[:, 0] * d[:, 1], upd3[:, 1])
        dm = torch.where(is_edge, upd2[:, 1], upd3[:, 2])
        u = torch.where(active, u + du, u)
        v = torch.where(active, v + dv, v)
        mean_diff = torch.where(active, mean_diff + dm, mean_diff)
        chi2 = torch.where(active, new_chi2, chi2)
        small = torch.where(is_edge, upd2[:, 0] ** 2 < 0.01 * 0.01,
                            upd3[:, 0] ** 2 + upd3[:, 1] ** 2 < 0.03 * 0.03)
        conv = conv | (active & small)
        active = active & ~small

    conv = conv & (chi2 <= 1000.0 * PATCH * PATCH) & valid
    final_patch, _, _ = _sample(windows, au, av, u, v)
    return {
        "px": torch.stack([u, v], dim=-1),
        "converged": conv,
        "chi2": chi2,
        "cur_patch": final_patch,
        "mean_diff": mean_diff,
    }


def _windows_for(cur_img, px_init, windows, anchors, img_hw):
    """The caller's prebuilt windows, or WIN-px windows cut from ``cur_img``
    around the initial estimates."""
    if windows is not None:
        return windows, anchors, img_hw
    h, w = cur_img.shape
    au, av = clip_anchor(px_init[:, 0], px_init[:, 1], WIN, BORD, h, w)
    return extract_windows(cur_img, au, av, WIN), (au, av), (h, w)


def align2d(cur_img, ref_border, px_init, n_iter: int = 10, valid=None,
            windows=None, anchors=None, img_hw=None):
    """Batched 2-D alignment (3-DoF [u, v, mean]) of every candidate.

    ``cur_img`` is the (H, W) search image (one pyramid level), or None when
    prebuilt ``windows`` + ``anchors`` + ``img_hw`` are given; ``ref_border``
    (N, 10, 10) the warped, exposure-compensated template with border;
    ``px_init`` (N, 2) in ``cur_img`` coordinates.

    Returns dict(px, converged, chi2, cur_patch, mean_diff)."""
    n = ref_border.shape[0]
    dev = ref_border.device
    windows, anchors, img_hw = _windows_for(cur_img, px_init, windows, anchors, img_hw)
    direction = torch.tensor([1.0, 0.0], device=dev).expand(n, 2)
    return align_mixed(torch.zeros((n,), dtype=torch.bool, device=dev), direction, ref_border,
                       px_init, n_iter=n_iter, valid=valid, windows=windows, anchors=anchors,
                       img_hw=img_hw)


def align1d(cur_img, direction, ref_border, px_init, n_iter: int = 10, valid=None,
            windows=None, anchors=None, img_hw=None):
    """Batched 1-D alignment: motion restricted to ``direction`` (N, 2), plus
    a mean-intensity DoF.  Returns the dict of :func:`align2d` and ``h_inv``,
    the patch-normalised inverse of the along-direction Hessian entry."""
    n = ref_border.shape[0]
    dev = ref_border.device
    windows, anchors, img_hw = _windows_for(cur_img, px_init, windows, anchors, img_hw)
    out = align_mixed(torch.ones((n,), dtype=torch.bool, device=dev), direction, ref_border,
                      px_init, n_iter=n_iter, valid=valid, windows=windows, anchors=anchors,
                      img_hw=img_hw)
    _, dx, dy = _template_grads(ref_border)
    d = direction / torch.clamp_min(torch.linalg.norm(direction, dim=-1, keepdim=True), 1e-9)
    jd = dx * d[:, None, None, 0] + dy * d[:, None, None, 1]
    h00 = torch.sum(jd * jd * torch.sqrt(250.0 / (250.0 + jd * jd)), dim=(1, 2)) * 1.001
    out["h_inv"] = 1.0 / h00 * PATCH * PATCH
    return out


def ncc(patch_a: torch.Tensor, patch_b: torch.Tensor) -> torch.Tensor:
    """Batched zero-mean NCC between (N, P, P) patches."""
    a = patch_a.reshape(patch_a.shape[0], -1)
    b = patch_b.reshape(patch_b.shape[0], -1)
    a = a - torch.mean(a, dim=-1, keepdim=True)
    b = b - torch.mean(b, dim=-1, keepdim=True)
    num = torch.sum(a * b, dim=-1)
    den = torch.sqrt(torch.sum(a * a, dim=-1) * torch.sum(b * b, dim=-1)) + 1e-12
    return num / den

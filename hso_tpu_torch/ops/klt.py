"""Batched pyramidal KLT tracking (the bootstrap's feature tracking).

Coarse-to-fine template alignment of every feature at once with the batched
2-D alignment (8×8 patches, two refinement sweeps a level, then a check at
level 0 with an NCC gate).  Each level cuts 16×16 windows around the
reference features (kernel K1 on the card) and samples the 10×10 bordered
templates inside them; ``align2d`` cuts its own 24×24 search windows (K1) and
aligns (K4).  A loop of eager calls with no host sync on the card.
"""

from __future__ import annotations

import torch

from hso_tpu_torch.ops.align import align2d, ncc
from hso_tpu_torch.ops.gatherless import bilinear_grid, clip_anchor, extract_windows

TEMPLATE_WIN = 16      #: window edge the templates are sampled from
TEMPLATE = 10          #: bordered template edge (8×8 patch + 1 px border)


def _templates(img, px_lvl):
    """10×10 bordered templates centred at ``px_lvl`` (one pyramid level)."""
    h, w = img.shape
    au, av = clip_anchor(px_lvl[:, 0], px_lvl[:, 1], TEMPLATE_WIN, TEMPLATE, h, w)
    wins = extract_windows(img, au, av, TEMPLATE_WIN)
    rel_u = (px_lvl[:, 0] - 5.0) - au.to(torch.float32)
    rel_v = (px_lvl[:, 1] - 5.0) - av.to(torch.float32)
    return bilinear_grid(wins, rel_u, rel_v, TEMPLATE)


def track_klt(ref_pyr, cur_pyr, px_ref, valid, px_prior=None,
              n_levels: int = 4, n_sweeps: int = 2):
    """Track ``px_ref`` (N, 2) from ``ref_pyr`` to ``cur_pyr`` (tuples of
    float32 pyramid levels, level 0 first), optionally starting from
    ``px_prior`` (e.g. the last attempt's tracked positions).

    Returns dict(px_cur (N, 2), ok (N,), ncc (N,))."""
    px_cur = px_ref if px_prior is None else px_prior
    for lvl in range(n_levels - 1, -1, -1):
        scale = 1.0 / (1 << lvl)
        tmpl = _templates(ref_pyr[lvl], px_ref * scale)
        for _ in range(n_sweeps):
            out = align2d(cur_pyr[lvl], tmpl, px_cur * scale, valid=valid)
            px_cur = torch.where(out["converged"][:, None], out["px"] * float(1 << lvl), px_cur)
    # final check at level 0
    tmpl0 = _templates(ref_pyr[0], px_ref)
    out0 = align2d(cur_pyr[0], tmpl0, px_cur, valid=valid)
    px_fin = torch.where(out0["converged"][:, None], out0["px"], px_cur)
    score = ncc(tmpl0[:, 1:9, 1:9], out0["cur_patch"])
    ok = valid & out0["converged"] & (score > 0.6)
    return {"px_cur": px_fin, "ok": ok, "ncc": score}

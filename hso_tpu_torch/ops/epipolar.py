"""Level-packed window extraction for the matcher.

Of the JAX package's ``ops/epipolar.py`` only ``pack_level_windows`` is
ported so far; the epipolar ZMNCC line search belongs to the depth-filter
sweep and is not ported yet.
"""

from __future__ import annotations

import torch

from hso_tpu_torch.ops.gatherless import clip_anchor
from hso_tpu_torch.ops.window_cuda import pack_level_windows_gather


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

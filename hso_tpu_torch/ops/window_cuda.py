"""Per-feature window extraction: CUDA kernels K1/K2 and their plain versions.

Counterpart of the JAX package's ``ops/window_pallas.py``
(``extract_windows_tpu``, ``pack_level_windows_tpu``).  The device code is
``csrc/window.cu``: one gather routine, with and without a per-row pyramid
level.  Dispatch rule: a CPU tensor takes the plain version, a CUDA tensor
launches the kernel or raises — there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

#: launches of each kernel since the counter was last set to 0
LAUNCHES = {"extract_windows": 0, "pack_level_windows": 0}


def extract_windows_plain(img: torch.Tensor, au: torch.Tensor, av: torch.Tensor,
                          win: int) -> torch.Tensor:
    """(N, win, win) windows at integer top-left anchors by advanced indexing.
    Rows/columns outside the image read 0 (callers pre-clip the anchors with
    ``clip_anchor``, so that does not happen on the main path)."""
    h, w = img.shape
    ar = torch.arange(win, device=img.device, dtype=torch.int64)
    rows = av.to(torch.int64)[:, None] + ar[None, :]            # (N, win)
    cols = au.to(torch.int64)[:, None] + ar[None, :]
    inside = (((rows >= 0) & (rows < h))[:, :, None]
              & ((cols >= 0) & (cols < w))[:, None, :])
    vals = img[rows.clamp(0, h - 1)[:, :, None], cols.clamp(0, w - 1)[:, None, :]]
    return torch.where(inside, vals, torch.zeros_like(vals))


def extract_windows_cuda(img: torch.Tensor, au: torch.Tensor, av: torch.Tensor,
                         win: int) -> torch.Tensor:
    """K1: launch ``hso_extract_windows`` on the current stream."""
    from hso_tpu_torch import _cuda_build

    dev = img.device
    n = au.shape[0]
    check = _cuda_build.check_tensor
    check(img, torch.float32, img.shape[-2:], dev, "img")
    check(au, torch.int32, (n,), dev, "au")
    check(av, torch.int32, (n,), dev, "av")
    out = torch.empty((n, win, win), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    err = _cuda_build.lib().hso_extract_windows(
        img.data_ptr(), img.shape[0], img.shape[1], au.data_ptr(), av.data_ptr(),
        n, win, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _cuda_build.check(err, "hso_extract_windows")
    LAUNCHES["extract_windows"] += 1
    return out


def extract_windows(img: torch.Tensor, au: torch.Tensor, av: torch.Tensor,
                    win: int) -> torch.Tensor:
    """Extract (N, win, win) windows with integer top-left anchors."""
    if img.is_cuda:
        return extract_windows_cuda(img.contiguous(), au.contiguous(), av.contiguous(), win)
    return extract_windows_plain(img, au, av, win)


def pack_level_windows_plain(pyr, level: torch.Tensor, au: torch.Tensor,
                             av: torch.Tensor, win: int, n_levels: int) -> torch.Tensor:
    """Row s reads its (win × win) window from ``pyr[level[s]]`` at anchors
    (au[s], av[s]) in that level's coordinates: one extraction per level,
    merged by a masked select."""
    s = level.shape[0]
    windows = torch.zeros((s, win, win), dtype=torch.float32, device=level.device)
    for lvl in range(n_levels):
        w_lvl = extract_windows_plain(pyr[lvl], au, av, win)
        windows = torch.where((level == lvl)[:, None, None], w_lvl, windows)
    return windows


def pack_level_windows_cuda(pyr, level: torch.Tensor, au: torch.Tensor,
                            av: torch.Tensor, win: int, n_levels: int) -> torch.Tensor:
    """K2: launch ``hso_pack_level_windows`` on the current stream.  Rows whose
    level lies outside [0, n_levels) come back as zeros."""
    from hso_tpu_torch import _cuda_build

    dev = level.device
    s = level.shape[0]
    if n_levels > _cuda_build.LevelTable.MAX_LEVELS:
        raise ValueError(f"n_levels {n_levels} exceeds {_cuda_build.LevelTable.MAX_LEVELS}")
    check = _cuda_build.check_tensor
    check(level, torch.int32, (s,), dev, "level")
    check(au, torch.int32, (s,), dev, "au")
    check(av, torch.int32, (s,), dev, "av")
    table = _cuda_build.LevelTable()
    for lvl in range(n_levels):
        check(pyr[lvl], torch.float32, pyr[lvl].shape[-2:], dev, f"pyr[{lvl}]")
        table.img[lvl] = pyr[lvl].data_ptr()
        table.h[lvl], table.w[lvl] = pyr[lvl].shape
    out = torch.empty((s, win, win), dtype=torch.float32, device=dev)
    if s == 0:
        return out
    err = _cuda_build.lib().hso_pack_level_windows(
        ctypes.byref(table), n_levels, level.data_ptr(), au.data_ptr(), av.data_ptr(),
        s, win, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _cuda_build.check(err, "hso_pack_level_windows")
    LAUNCHES["pack_level_windows"] += 1
    return out


def pack_level_windows_gather(pyr, level, au, av, win: int, n_levels: int) -> torch.Tensor:
    """Dispatch of the multi-level gather (anchors already computed)."""
    if level.is_cuda:
        return pack_level_windows_cuda(
            [p.contiguous() for p in pyr[:n_levels]], level.contiguous(),
            au.contiguous(), av.contiguous(), win, n_levels)
    return pack_level_windows_plain(pyr, level, au, av, win, n_levels)

"""Scattered window sampling: per-feature windows and bilinear reads inside them.

Counterpart of the JAX package's ``ops/gatherless.py``.  That module writes
every irregular read as a one-hot or banded matrix product; on a GPU a read
at an irregular address is an ordinary gather, so here window extraction is
an index gather (a CUDA kernel on the card, :mod:`.window_cuda`) and every
sub-pixel sample is a 4-tap bilinear gather inside the feature's window.
The values are the same: a sample outside the window reads 0, and callers
mask with :func:`grid_in_window`.
"""

from __future__ import annotations

import torch

from hso_tpu_torch.ops.window_cuda import extract_windows  # noqa: F401  (re-export)


def clip_anchor(center_u, center_v, win: int, grid: int, h: int, w: int):
    """Integer window anchors centred on (center_u, center_v) with the G-grid
    centred, clipped to image bounds.  Returns int32 (au, av)."""
    off = (win - grid) // 2 + grid // 2
    au = torch.clamp(torch.floor(center_u).to(torch.int32) - off, 0, w - win)
    av = torch.clamp(torch.floor(center_v).to(torch.int32) - off, 0, h - win)
    return au, av


def bilinear_scatter_in_windows(windows: torch.Tensor, pu: torch.Tensor,
                                pv: torch.Tensor) -> torch.Tensor:
    """Sample M arbitrary sub-pixel points per window.

    windows (N, WIN, WIN); pu/pv (N, M) window coords ⇒ (N, M) values by a
    4-tap bilinear gather.  A tap outside the window reads 0, so a point
    outside the window fades to 0 over one pixel, exactly as the banded
    weights ``max(0, 1 - |p - x|)`` do.  Non-finite coordinates read 0.
    """
    n, win, _ = windows.shape
    finite = torch.isfinite(pu) & torch.isfinite(pv)
    pu = torch.where(finite, pu, torch.full_like(pu, -4.0)).clamp(-4.0, win + 4.0)
    pv = torch.where(finite, pv, torch.full_like(pv, -4.0)).clamp(-4.0, win + 4.0)
    x0f = torch.floor(pu)
    y0f = torch.floor(pv)
    fx = pu - x0f
    fy = pv - y0f
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    flat = windows.reshape(n, win * win)

    def tap(xi, yi, wgt):
        inside = (xi >= 0) & (xi < win) & (yi >= 0) & (yi < win)
        idx = yi.clamp(0, win - 1) * win + xi.clamp(0, win - 1)
        val = torch.gather(flat, 1, idx)
        return torch.where(inside, val * wgt, torch.zeros_like(val))

    return (tap(x0, y0, (1.0 - fx) * (1.0 - fy)) + tap(x0 + 1, y0, fx * (1.0 - fy))
            + tap(x0, y0 + 1, (1.0 - fx) * fy) + tap(x0 + 1, y0 + 1, fx * fy))


def bilinear_grid(windows: torch.Tensor, rel_u: torch.Tensor, rel_v: torch.Tensor,
                  grid: int) -> torch.Tensor:
    """Bilinearly sample a (grid × grid) patch from each window.

    ``rel_u/rel_v`` (N,) are window coordinates of the patch's (0, 0) grid
    point; grid spacing is 1 pixel.  Returns (N, grid, grid) with
    out[n, gy, gx] = bilerp(W_n)(rel_u + gx, rel_v + gy).
    """
    n = windows.shape[0]
    g = torch.arange(grid, dtype=torch.float32, device=windows.device)
    pu = (rel_u[:, None, None] + g[None, None, :]).expand(n, grid, grid)
    pv = (rel_v[:, None, None] + g[None, :, None]).expand(n, grid, grid)
    out = bilinear_scatter_in_windows(windows, pu.reshape(n, -1), pv.reshape(n, -1))
    return out.reshape(n, grid, grid)


def grid_in_window(rel_u, rel_v, grid: int, win: int):
    """True where the whole sampled grid lies inside the window."""
    return ((rel_u >= 0.0) & (rel_v >= 0.0)
            & (rel_u + grid - 1 <= win - 1.0) & (rel_v + grid - 1 <= win - 1.0))


def sample_points(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Scattered single-point bilinear reads of a whole (H, W) image:
    out[n] = bilerp(img)(u[n], v[n]) by a 4-tap gather.  A tap outside the
    image reads 0, and so does a non-finite coordinate."""
    h, w = img.shape
    finite = torch.isfinite(u) & torch.isfinite(v)
    u = torch.where(finite, u, torch.full_like(u, -4.0)).clamp(-4.0, w + 4.0)
    v = torch.where(finite, v, torch.full_like(v, -4.0)).clamp(-4.0, h + 4.0)
    x0f = torch.floor(u)
    y0f = torch.floor(v)
    fx = u - x0f
    fy = v - y0f
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    flat = img.reshape(-1)

    def tap(xi, yi, wgt):
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        val = flat[yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)]
        return torch.where(inside, val * wgt, torch.zeros_like(val))

    return (tap(x0, y0, (1.0 - fx) * (1.0 - fy)) + tap(x0 + 1, y0, fx * (1.0 - fy))
            + tap(x0, y0 + 1, (1.0 - fx) * fy) + tap(x0 + 1, y0 + 1, fx * fy))


def sample_gradient_in_windows(windows, au, av, u, v):
    """Central-difference image gradient at one sub-pixel point per window.

    ``windows`` (N, W, W) with integer image-coord anchors (au, av); (u, v)
    image coords.  Returns (gx, gy), each (N,).  Only the gradient
    direction is consumed downstream.
    """
    ru = u - au.to(torch.float32)
    rv = v - av.to(torch.float32)
    pu = torch.stack([ru + 1.0, ru - 1.0, ru, ru], dim=-1)
    pv = torch.stack([rv, rv, rv + 1.0, rv - 1.0], dim=-1)
    vals = bilinear_scatter_in_windows(windows, pu, pv)
    gx = 0.5 * (vals[:, 0] - vals[:, 1])
    gy = 0.5 * (vals[:, 2] - vals[:, 3])
    return gx, gy

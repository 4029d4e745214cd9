"""Feature detection: FAST-9 corners + Shi-Tomasi, edgelets, gradient
species, grid selection (torch).

The same dense score maps and per-cell selection as the JAX package's
``hso_tpu.ops.detect``: FAST-9 segment test as a cyclic AND of ring shifts,
a 3×3 non-maximum suppression with a scan-order tie-break, Shi-Tomasi over an
8×8 box, edgelets as the along-gradient maximum of the Sobel-5 magnitude
above 70·minThresh, the gradient species in cells no corner or edgelet
claimed, and a top-k over cells ranked by spatial-uniformity tiers.

Selection is where float order and ties decide the result, so this module
keeps the JAX formulation where it decides: the box sums are shifted-slice
adds in the same order (``_box_sum``), the per-cell argmax takes the first
maximum, and the top-k is a stable descending sort (the lower index first on
a tie, as ``jax.lax.top_k``).  The occupancy grid is one index write.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

#: Bresenham circle radius-3 ring, clockwise from 12 o'clock (dx, dy)
FAST_RING = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    np.int32,
)

# species codes (match Feature::FeatureType roles)
CORNER, EDGELET, GRADIENT = 0, 1, 2
#: score offset that lifts corners above edgelets in the per-cell merge
CORNER_PRIORITY = 1e6


def _shift2d(img: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """img shifted so out[y, x] = img[y + dy, x + dx] (zero padded)."""
    h, w = img.shape
    out = torch.zeros_like(img)
    out[max(-dy, 0):h + min(-dy, 0), max(-dx, 0):w + min(-dx, 0)] = \
        img[max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)]
    return out


def _box_sum(img: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Sum over the box offsets [lo, hi) in both axes, as separable
    shifted-slice adds in a fixed order (rows first, then columns)."""
    h, w = img.shape
    n = hi - lo
    x = F.pad(img, (0, 0, -lo, hi - 1))
    acc = x[0:h, :]
    for k in range(1, n):
        acc = acc + x[k:k + h, :]
    x = F.pad(acc, (-lo, hi - 1, 0, 0))
    acc = x[:, 0:w]
    for k in range(1, n):
        acc = acc + x[:, k:k + w]
    return acc


def _inside(h: int, w: int, margin: int, device, upper_inclusive: bool = False):
    """(h, w) mask of pixels at least ``margin`` from the left/top edge and
    below ``w - margin`` (or up to it, with ``upper_inclusive``)."""
    yy = torch.arange(h, device=device)[:, None]
    xx = torch.arange(w, device=device)[None, :]
    if upper_inclusive:
        return (xx >= margin) & (xx <= w - margin) & (yy >= margin) & (yy <= h - margin)
    return (xx >= margin) & (xx < w - margin) & (yy >= margin) & (yy < h - margin)


def shi_tomasi_map(img: torch.Tensor) -> torch.Tensor:
    """Dense Shi-Tomasi (min structure-tensor eigenvalue), 8×8 box whose
    top-left is (u-4, v-4), raw right-left differences, /(2·box_area)."""
    dx = _shift2d(img, 1, 0) - _shift2d(img, -1, 0)
    dy = _shift2d(img, 0, 1) - _shift2d(img, 0, -1)
    norm = 1.0 / (2.0 * 64.0)
    dxx = _box_sum(dx * dx, -4, 4) * norm
    dyy = _box_sum(dy * dy, -4, 4) * norm
    dxy = _box_sum(dx * dy, -4, 4) * norm
    tr = dxx + dyy
    disc = torch.sqrt(torch.clamp_min(tr * tr - 4.0 * (dxx * dyy - dxy * dxy), 0.0))
    score = 0.5 * (dxx + dyy - disc)
    h, w = img.shape
    # zero near the boundary (the patch must fit: 5 px margin)
    return torch.where(_inside(h, w, 5, img.device), score, torch.zeros_like(score))


def fast9_mask(img: torch.Tensor, thresh) -> torch.Tensor:
    """FAST-9 segment test: ≥ 9 contiguous ring pixels all brighter than
    center+t or all darker than center−t (cyclic AND of ring shifts)."""
    rings = torch.stack([_shift2d(img, int(dx), int(dy)) for dx, dy in FAST_RING])
    bright = rings > img[None] + thresh
    dark = rings < img[None] - thresh

    def has_run9(m):
        acc = m
        for k in range(1, 9):
            acc = acc & torch.roll(m, -k, dims=0)
        return torch.any(acc, dim=0)

    corner = has_run9(bright) | has_run9(dark)
    h, w = img.shape
    return corner & _inside(h, w, 3, img.device)


def nms3_keep(score: torch.Tensor) -> torch.Tensor:
    """True where score is the max of its 3×3 neighbourhood; on a tie the
    neighbour that precedes in scan order wins, so a plateau keeps exactly
    one pixel."""
    keep = torch.ones_like(score, dtype=torch.bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            n = _shift2d(score, dx, dy)
            keep &= (score > n) if (dy, dx) < (0, 0) else (score >= n)
    return keep


def edgelet_map(sobel_x: torch.Tensor, sobel_y: torch.Tensor, min_thresh):
    """(edge_strength, gx, gy): gradient magnitude where it is a local max
    along the gradient direction (4 direction bins) and above 70·minThresh."""
    mag = torch.sqrt(sobel_x * sobel_x + sobel_y * sobel_y)
    ax = torch.abs(sobel_x)
    ay = torch.abs(sobel_y)
    ratio = ay / torch.clamp_min(ax, 1e-6)
    horiz = ratio < 0.4142135624               # gradient along x: neighbours x±1
    vert = ratio > 2.4142135624                # gradient along y: neighbours y±1
    diag_main = (~horiz) & (~vert) & (torch.sign(sobel_x) == torch.sign(sobel_y))
    n1 = torch.where(horiz, _shift2d(mag, 1, 0),
                     torch.where(vert, _shift2d(mag, 0, 1),
                                 torch.where(diag_main, _shift2d(mag, 1, 1),
                                             _shift2d(mag, 1, -1))))
    n2 = torch.where(horiz, _shift2d(mag, -1, 0),
                     torch.where(vert, _shift2d(mag, 0, -1),
                                 torch.where(diag_main, _shift2d(mag, -1, -1),
                                             _shift2d(mag, -1, 1))))
    keep = (mag >= n1) & (mag > n2) & (mag > 70.0 * min_thresh)
    return torch.where(keep, mag, torch.zeros_like(mag)), sobel_x, sobel_y


def _cell_argmax(score: torch.Tensor, cell: int):
    """Per-cell max and the (y, x) of its first maximum; pads to cell
    multiples.  Returns (best (Cy, Cx), y (Cy, Cx), x (Cy, Cx))."""
    h, w = score.shape
    cy = -(-h // cell)
    cx = -(-w // cell)
    pad = F.pad(score, (0, cx * cell - w, 0, cy * cell - h))
    blocks = pad.reshape(cy, cell, cx, cell).permute(0, 2, 1, 3).reshape(cy, cx, -1)
    best = torch.amax(blocks, dim=-1)
    idx = torch.argmax(blocks, dim=-1)          # the first maximum
    dev = score.device
    gy = torch.arange(cy, device=dev)[:, None] * cell + idx // cell
    gx = torch.arange(cx, device=dev)[None, :] * cell + idx % cell
    return best, gy, gx


def _fit(a: torch.Tensor, cy: int, cx: int) -> torch.Tensor:
    """Pad-or-crop a per-cell map to the global (cy, cx) grid (level grids can
    differ by one cell when image dims aren't divisible)."""
    a = a[:min(a.shape[0], cy), :min(a.shape[1], cx)]
    return F.pad(a, (0, cx - a.shape[1], 0, cy - a.shape[0]))


def _gather_cells(img: torch.Tensor, gy: torch.Tensor, gx: torch.Tensor) -> torch.Tensor:
    """Read img at per-cell argmax positions."""
    h, w = img.shape
    idx = torch.clamp(gy, 0, h - 1) * w + torch.clamp(gx, 0, w - 1)
    return img.reshape(-1)[idx.reshape(-1)].reshape(gy.shape).to(torch.float32)


def _block_winner(score: torch.Tensor, b: int) -> torch.Tensor:
    """Cells that hold the maximum of their b×b block of cells (and score)."""
    cyl, cxl = score.shape
    by, bx = -(-cyl // b), -(-cxl // b)
    pad = F.pad(score, (0, bx * b - cxl, 0, by * b - cyl))
    bmax = torch.amax(pad.reshape(by, b, bx, b), dim=(1, 3))
    up = bmax.repeat_interleave(b, 0).repeat_interleave(b, 1)[:cyl, :cxl]
    return (score >= up) & (score > 0.0)


def detect_features(pyr, sobel_x, sobel_y, grad_mean, occupied, n_levels: int = 3,
                    cell0: int = 32, n_out: int = 384, border: int = 8,
                    with_gradient: bool = True):
    """Hybrid detection over the pyramid → top-``n_out`` features.

    ``occupied`` (Cy, Cx) bool marks cells already holding tracked features.
    Returns a dict of (n_out,) tensors: ``px`` (level-0 coords, (n_out, 2)),
    ``level``, ``species``, ``score``, ``grad`` (normalised gradient normal),
    ``valid``."""
    dev = pyr[0].device
    f32 = torch.float32
    h0, w0 = pyr[0].shape
    cy = -(-h0 // cell0)
    cx = -(-w0 // cell0)

    best_score = torch.zeros((cy, cx), dtype=f32, device=dev)
    # meta: x0, y0, level, species, gx, gy
    best_meta = [torch.zeros((cy, cx), dtype=f32, device=dev) for _ in range(6)]

    def merge(cond, score, x0, y0, level, species, gx, gy):
        nonlocal best_score, best_meta
        upd = cond & (score > best_score)
        best_score = torch.where(upd, score, best_score)
        vals = [x0, y0, torch.full_like(x0, level), torch.full_like(x0, species), gx, gy]
        best_meta = [torch.where(upd, v, m) for v, m in zip(vals, best_meta)]

    def level_cells(score, lvl):
        best, gy_l, gx_l = _cell_argmax(score, max(cell0 >> lvl, 4))
        return _fit(best, cy, cx), _fit(gy_l, cy, cx), _fit(gx_l, cy, cx)

    # pass 1: corners (priority species: an offset lifts them above edgelets)
    for lvl in range(n_levels):
        img = pyr[lvl]
        hl, wl = img.shape
        st = shi_tomasi_map(img)
        corner = fast9_mask(img, grad_mean)
        masked = torch.where(corner & _inside(hl, wl, border, dev, True), st,
                             torch.zeros_like(st))
        # NMS among corner candidates only (non-corner neighbours don't compete)
        cscore = torch.where(nms3_keep(masked), masked, torch.zeros_like(masked))
        cbest, gy_l, gx_l = level_cells(cscore, lvl)
        scale = float(1 << lvl)
        zero = torch.zeros_like(cbest)
        merge(cbest > 0.0, cbest + CORNER_PRIORITY, gx_l.to(f32) * scale,
              gy_l.to(f32) * scale, float(lvl), float(CORNER), zero, zero)

    # pass 2: edgelets (only beat empty cells: scores lack the priority offset)
    for lvl in range(n_levels):
        emag, sx, sy = edgelet_map(sobel_x[lvl], sobel_y[lvl], grad_mean)
        hl, wl = pyr[lvl].shape
        escore = torch.where(_inside(hl, wl, border, dev, True), emag, torch.zeros_like(emag))
        ebest, gy_l, gx_l = level_cells(escore, lvl)
        scale = float(1 << lvl)
        merge(ebest > 0.0, ebest, gx_l.to(f32) * scale, gy_l.to(f32) * scale,
              float(lvl), float(EDGELET), _gather_cells(sx, gy_l, gx_l),
              _gather_cells(sy, gy_l, gx_l))

    best_score = torch.where(occupied, torch.zeros_like(best_score), best_score)

    # pass 3: gradient species: a cell no corner or edgelet claimed takes its
    # max-|∇I| pixel when it clears 20·minThresh
    if with_gradient:
        gscore = torch.zeros((cy, cx), dtype=f32, device=dev)
        gmeta = [torch.zeros((cy, cx), dtype=f32, device=dev) for _ in range(6)]
        for lvl in range(n_levels):
            mag = torch.sqrt(sobel_x[lvl] * sobel_x[lvl] + sobel_y[lvl] * sobel_y[lvl])
            hl, wl = pyr[lvl].shape
            gmag = torch.where(_inside(hl, wl, border, dev, True) & (mag > 20.0 * grad_mean),
                               mag, torch.zeros_like(mag))
            gbest, gy_l, gx_l = level_cells(gmag, lvl)
            scale = float(1 << lvl)
            upd = gbest > gscore
            gscore = torch.where(upd, gbest, gscore)
            vals = [gx_l.to(f32) * scale, gy_l.to(f32) * scale,
                    torch.full_like(gbest, float(lvl)), torch.full_like(gbest, float(GRADIENT)),
                    _gather_cells(sobel_x[lvl], gy_l, gx_l),
                    _gather_cells(sobel_y[lvl], gy_l, gx_l)]
            gmeta = [torch.where(upd, v, m) for v, m in zip(vals, gmeta)]
        fill = (best_score <= 0.0) & ~occupied & (gscore > 0.0)
        best_score = torch.where(fill, gscore, best_score)
        best_meta = [torch.where(fill, g, m) for g, m in zip(gmeta, best_meta)]

    # spatial-uniformity tiers: a 2×2-block winner outranks every runner-up,
    # a 4×4-block winner outranks 2×2 winners
    zero = torch.zeros_like(best_score)
    sel_score = (best_score
                 + torch.where(_block_winner(best_score, 2), zero + 1e8, zero)
                 + torch.where(_block_winner(best_score, 4), zero + 2e8, zero))

    flat_score = best_score.reshape(-1)
    k = min(n_out, flat_score.shape[0])
    # top-k as a stable descending sort: on a tie the lower cell index first
    top_idx = torch.sort(sel_score.reshape(-1), descending=True, stable=True).indices[:k]
    top_scores = flat_score[top_idx]
    x0, y0, level, species, gx, gy = [m.reshape(-1)[top_idx] for m in best_meta]
    valid = top_scores > 0.0
    gnorm = torch.sqrt(gx * gx + gy * gy)
    grad = torch.stack([gx, gy], dim=-1) / torch.clamp_min(gnorm, 1e-6)[:, None]
    score = torch.where(valid, torch.where(species == CORNER, top_scores - CORNER_PRIORITY,
                                           top_scores), torch.zeros_like(top_scores))

    pad = n_out - k

    def padded(a):
        return F.pad(a, (0, 0) * (a.ndim - 1) + (0, pad)) if pad else a

    return {
        "px": padded(torch.stack([x0, y0], dim=-1)),
        "level": padded(level.to(torch.int32)),
        "species": padded(species.to(torch.int32)),
        "score": padded(score),
        "grad": padded(grad),
        "valid": padded(valid),
    }


def occupancy_grid(px, valid, h: int, w: int, cell0: int):
    """(Cy, Cx) bool: cells that hold a valid feature of ``px`` (N, 2) level-0
    coordinates.  One index write; rows that are not valid land in a spare
    cell past the grid, which is dropped."""
    cy = -(-h // cell0)
    cx = -(-w // cell0)

    def cell_of(x, hi):
        c = torch.div(x, float(cell0), rounding_mode="floor")
        # clamp in float first: the cast of a non-finite value is undefined
        return torch.nan_to_num(c, nan=0.0).clamp(0, hi).to(torch.int64)

    cidx = cell_of(px[:, 1], cy - 1) * cx + cell_of(px[:, 0], cx - 1)
    cidx = torch.where(valid, cidx, torch.full_like(cidx, cy * cx))
    grid = torch.zeros((cy * cx + 1,), dtype=torch.bool, device=px.device)
    grid.index_fill_(0, cidx, True)
    return grid[:cy * cx].reshape(cy, cx)

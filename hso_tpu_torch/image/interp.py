"""Bilinear reads of a whole image at irregular sub-pixel coordinates.

Four-tap gathers over the flattened image.  All functions are
shape-polymorphic over leading batch dimensions and clamp the tap indices to
the image (callers carry validity masks).
"""

from __future__ import annotations

import torch


def _gather2d(img: torch.Tensor, vi: torch.Tensor, ui: torch.Tensor) -> torch.Tensor:
    h, w = img.shape
    vi = torch.clamp(vi, 0, h - 1)
    ui = torch.clamp(ui, 0, w - 1)
    return img.reshape(-1)[vi * w + ui]


def bilinear(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """I(u, v) with bilinear weights; u along width, v along height."""
    uf = torch.floor(u)
    vf = torch.floor(v)
    fu = u - uf
    fv = v - vf
    ui = uf.to(torch.int64)
    vi = vf.to(torch.int64)
    return ((1.0 - fu) * (1.0 - fv) * _gather2d(img, vi, ui)
            + fu * (1.0 - fv) * _gather2d(img, vi, ui + 1)
            + (1.0 - fu) * fv * _gather2d(img, vi + 1, ui)
            + fu * fv * _gather2d(img, vi + 1, ui + 1))


def bilinear_with_grad(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """(I, dI/du, dI/dv) at sub-pixel (u, v).  Gradients are the bilinear
    interpolation of central differences: dx = 0.5 · (I(u+1, v) − I(u−1, v))."""
    val = bilinear(img, u, v)
    dx = 0.5 * (bilinear(img, u + 1.0, v) - bilinear(img, u - 1.0, v))
    dy = 0.5 * (bilinear(img, u, v + 1.0) - bilinear(img, u, v - 1.0))
    return val, dx, dy


def patch_values(img: torch.Tensor, u0: torch.Tensor, v0: torch.Tensor,
                 offsets: torch.Tensor) -> torch.Tensor:
    """Bilinear patch gather: centres (N,), pattern ``offsets`` (P, 2) in
    pixels ⇒ values (N, P).  Offset x adds to u, y to v."""
    u = u0[:, None] + offsets[None, :, 0].to(img.dtype)
    v = v0[:, None] + offsets[None, :, 1].to(img.dtype)
    return bilinear(img, u, v)


def patch_values_with_grad(img: torch.Tensor, u0: torch.Tensor, v0: torch.Tensor,
                           offsets: torch.Tensor):
    """As :func:`patch_values` but also the (N, P) image gradients."""
    u = u0[:, None] + offsets[None, :, 0].to(img.dtype)
    v = v0[:, None] + offsets[None, :, 1].to(img.dtype)
    return bilinear_with_grad(img, u, v)

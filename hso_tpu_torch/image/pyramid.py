"""Image frontend: pyramid, Sobel pyramid, photometric frame statistics.

One function produces the whole pyramid stack, Sobel-5 gradient pyramids,
the mean interior gradient magnitude (FC/IC choice, keyframe criterion) and
the mean interior intensity (exposure-ratio prior).  Images are float32 in
[0, 255] throughout.

The Sobel filter is shift-and-add over slices, never a cuDNN convolution: a
float32 cuDNN convolution runs in TF32 by default, which keeps about three
decimal digits and would break parity with the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

#: OpenCV ksize=5 separable Sobel taps: smooth ⊗ derivative
_SOBEL5_SMOOTH = (1.0, 4.0, 6.0, 4.0, 1.0)
_SOBEL5_DERIV = (-1.0, -2.0, 0.0, 2.0, 1.0)


def half_sample(img: torch.Tensor) -> torch.Tensor:
    """2x2 box-filter downsample (odd trailing row/column dropped)."""
    h2, w2 = img.shape[0] // 2, img.shape[1] // 2
    img = img[: 2 * h2, : 2 * w2]
    return (img[0::2, 0::2] + img[0::2, 1::2] + img[1::2, 0::2] + img[1::2, 1::2]) * 0.25


def _pad_replicate(img, top, bottom, left, right):
    return F.pad(img[None, None], (left, right, top, bottom), mode="replicate")[0, 0]


def _sep_filter_replicate(img: torch.Tensor, kv, kh) -> torch.Tensor:
    """Separable 2D filter with edge-replicate padding (cv BORDER_REPLICATE):
    vertical taps ``kv`` then horizontal taps ``kh``, as tap sums over
    stride-1 slices in the same order as the JAX package."""
    pad = len(kv) // 2
    h, w = img.shape
    x = _pad_replicate(img, pad, pad, 0, 0)
    acc = None
    for k, c in enumerate(kv):
        if c == 0.0:
            continue
        term = float(c) * x[k: k + h, :]
        acc = term if acc is None else acc + term
    x = _pad_replicate(acc, 0, 0, pad, pad)
    acc = None
    for k, c in enumerate(kh):
        if c == 0.0:
            continue
        term = float(c) * x[:, k: k + w]
        acc = term if acc is None else acc + term
    return acc


def sobel5(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(gx, gy) with OpenCV Sobel ksize=5 semantics."""
    gx = _sep_filter_replicate(img, _SOBEL5_SMOOTH, _SOBEL5_DERIV)
    gy = _sep_filter_replicate(img, _SOBEL5_DERIV, _SOBEL5_SMOOTH)
    return gx, gy


def build_frame_pyramids(img_u8, n_pyr_levels: int = 3, n_total_levels: int = 5,
                         device="cuda"):
    """Pyramid + Sobel pyramids + frame statistics.

    ``img_u8`` is an (H, W) numpy array or tensor (any real dtype); it is
    moved to ``device`` as float32.  Returns a dict:
      ``pyr``       tuple of ``n_total_levels`` float32 images (level 0 full res)
      ``sobel_x/y`` tuples of ``n_pyr_levels`` gradient images
      ``grad_mean`` clipped mean interior |∇I| (/30, clip [7, 20])
      ``intensity_mean`` mean interior intensity (exposure prior)
    """
    if isinstance(img_u8, np.ndarray):
        img_u8 = torch.from_numpy(np.ascontiguousarray(img_u8))
    img0 = img_u8.to(device=device, dtype=torch.float32)
    pyr = [img0]
    for _ in range(1, n_total_levels):
        pyr.append(half_sample(pyr[-1]))

    sobel_x, sobel_y = [], []
    for lvl in range(n_pyr_levels):
        gx, gy = sobel5(pyr[lvl])
        sobel_x.append(gx)
        sobel_y.append(gy)

    # interior margin of 16 px; degrade gracefully for images too small to
    # have one (unit-test sizes)
    m = 16 if min(img0.shape[0], img0.shape[1]) > 32 else 0
    interior = (slice(m, img0.shape[0] - m or None), slice(m, img0.shape[1] - m or None))
    gmag = torch.sqrt(sobel_x[0][interior] ** 2 + sobel_y[0][interior] ** 2)
    grad_mean = torch.clamp(torch.mean(gmag) / 30.0, 7.0, 20.0)
    intensity_mean = torch.mean(img0[interior])

    return {
        "pyr": tuple(pyr),
        "sobel_x": tuple(sobel_x),
        "sobel_y": tuple(sobel_y),
        "grad_mean": grad_mean,
        "intensity_mean": intensity_mean,
    }


def remap_bilinear(img: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor) -> torch.Tensor:
    """Whole-image undistortion: out[i, j] = bilinear(img, map_x[i, j],
    map_y[i, j]); source pixels outside the image clamp to the border."""
    from hso_tpu_torch.image.interp import bilinear

    vals = bilinear(img.to(torch.float32), map_x.reshape(-1), map_y.reshape(-1))
    return vals.reshape(map_x.shape)

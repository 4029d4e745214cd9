"""Robust statistics: masked medians, MAD scale, Huber and Tukey weights (torch).

Every statistic takes a validity mask so it runs over padded slot arrays
without dynamic shapes (and so without a host sync).
"""

from __future__ import annotations

import torch

#: 1 / Phi^-1(3/4) — consistency constant for MAD
MAD_NORMALIZER = 1.4826


def masked_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Upper median of ``values[mask]`` (1-D) without dynamic shapes.

    Invalid entries are pushed to +inf, the array is sorted and element
    ``n_valid // 2`` is taken — the element an ``nth_element`` median picks,
    not the mean of the middle pair (``torch.median`` returns the LOWER
    median and is deliberately not used).  An empty mask gives 0.
    """
    n_valid = torch.sum(mask.to(torch.int64))
    big = torch.full_like(values, float("inf"))
    sorted_vals, _ = torch.sort(torch.where(mask, values, big))
    idx = torch.clamp(n_valid // 2, 0, values.shape[0] - 1)
    med = sorted_vals.gather(0, idx.reshape(1)).reshape(())
    return torch.where(n_valid > 0, med, torch.zeros_like(med))


def masked_median_bisect(values: torch.Tensor, mask: torch.Tensor,
                         n_iter: int = 30) -> torch.Tensor:
    """Masked upper median by value-range bisection: O(n · iters) elementwise
    passes instead of a sort.  Converges to the upper-median value within
    (max − min) / 2^n_iter — for medians that feed a robust threshold, not for
    an exact order statistic."""
    finite = mask & torch.isfinite(values)
    n_valid = torch.sum(finite.to(torch.int64))
    target = n_valid // 2 + 1          # upper median, 1-based rank
    lo = torch.min(torch.where(finite, values, torch.full_like(values, float("inf"))))
    hi = torch.max(torch.where(finite, values, torch.full_like(values, float("-inf"))))
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        hit = torch.sum(((values <= mid) & finite).to(torch.int64)) >= target
        lo, hi = torch.where(hit, lo, mid), torch.where(hit, mid, hi)
    med = 0.5 * (lo + hi)
    return torch.where(n_valid > 0, med, torch.zeros_like(med))


def masked_mad_sigma(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """1.4826 * median(|v - median(v)|) over the masked entries."""
    med = masked_median(values, mask)
    return MAD_NORMALIZER * masked_median(torch.abs(values - med), mask)


def mad_scale_of_abs(abs_errors: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """1.4826 * median(|e|) for already-absolute errors (pose optimizer)."""
    return MAD_NORMALIZER * masked_median(abs_errors, mask)


def huber_weight(x_over_sigma: torch.Tensor, k: float = 1.345) -> torch.Tensor:
    """w(x) = 1 if |x| < k else k/|x|."""
    ax = torch.abs(x_over_sigma)
    return torch.where(ax < k, torch.ones_like(ax), k / torch.clamp_min(ax, 1e-12))


def tukey_weight(x_over_sigma: torch.Tensor, b: float = 4.6851) -> torch.Tensor:
    """w(x) = (1 − (x/b)²)² for |x| < b else 0."""
    r = x_over_sigma / b
    w = 1.0 - r * r
    return torch.where(torch.abs(x_over_sigma) < b, w * w, torch.zeros_like(w))

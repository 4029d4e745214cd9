"""Closed-form small-matrix ops for batched hot paths (torch).

Unrolled so that an LM loop pays a few dozen elementwise ops instead of a
pivoted LU call, and so that the device kernels' scalar solvers
(``csrc/common.cuh``) can mirror the arithmetic line by line.
"""

from __future__ import annotations

import torch


def solve_spd_small(A: torch.Tensor, b: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Solve A x = b for a small SPD system (n ≤ ~10) by an unrolled Cholesky
    and two triangular substitutions.

    Damped Gauss-Newton systems are SPD by construction; ``eps`` guards
    rank-deficient-but-positive corners, while a genuinely non-positive pivot
    propagates NaN so the callers' ``isfinite`` gates reject the step.
    """
    n = A.shape[-1]
    nan = torch.full_like(A[..., 0, 0], float("nan"))
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(torch.where(s <= 0, nan, torch.clamp_min(s, eps)))
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def det2x2(A: torch.Tensor) -> torch.Tensor:
    return A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]


def _guard_det(det, eps):
    return torch.where(torch.abs(det) < eps, torch.full_like(det, eps), det)


def inv2x2(A: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Batched 2×2 inverse via the adjugate; near-singular inputs produce
    large-but-finite entries (callers gate with their own validity masks)."""
    a, b = A[..., 0, 0], A[..., 0, 1]
    c, d = A[..., 1, 0], A[..., 1, 1]
    det = _guard_det(a * d - b * c, eps)
    adj = torch.stack([torch.stack([d, -b], dim=-1), torch.stack([-c, a], dim=-1)], dim=-2)
    return adj / det[..., None, None]


def inv3x3(A: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Batched 3×3 inverse via the adjugate."""
    m = A
    c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
    c01 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
    c02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
    c10 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
    c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
    c12 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
    c20 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
    c21 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
    c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    det = _guard_det(m[..., 0, 0] * c00 + m[..., 0, 1] * c01 + m[..., 0, 2] * c02, eps)
    adj = torch.stack([
        torch.stack([c00, c10, c20], dim=-1),
        torch.stack([c01, c11, c21], dim=-1),
        torch.stack([c02, c12, c22], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]

"""SE(3) on torch tensors (float32), the device-side pose algebra.

Same conventions and the same formulas as
:mod:`hso_tpu_torch.math._se3_impl` (``(..., 3, 4)`` ``[R | t]``, tangent
``[rho, phi]``, small-angle Taylor guards at ``eps = 1e-6``), written
directly on tensors so every result lives on the device of its inputs.
All small contractions are broadcast multiply+sum: no cuBLAS call for a
3×3 product.  All functions broadcast over leading batch dimensions.
"""

from __future__ import annotations

import torch

_EPS = 1e-6


def identity(batch_shape=(), device=None) -> torch.Tensor:
    I = torch.cat([torch.eye(3, dtype=torch.float32, device=device),
                   torch.zeros((3, 1), dtype=torch.float32, device=device)], dim=-1)
    return I.expand(tuple(batch_shape) + (3, 4)).clone()


def from_Rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.cat([R, t[..., :, None]], dim=-1)


def rotation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def _mv(R, v):
    return torch.sum(R * v[..., None, :], dim=-1)


def _mm(A, B):
    return torch.sum(A[..., :, :, None] * B[..., None, :, :], dim=-2)


def mul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Compose: (A*B) maps via B first, then A."""
    R = _mm(rotation(A), rotation(B))
    t = _mv(rotation(A), translation(B)) + translation(A)
    return from_Rt(R, t)


def inv(T: torch.Tensor) -> torch.Tensor:
    Rt = rotation(T).transpose(-1, -2)
    return from_Rt(Rt, -_mv(Rt, translation(T)))


def apply(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Transform points ``p`` (..., 3)."""
    return _mv(rotation(T), p) + translation(T)


def rotate(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return _mv(rotation(T), p)


def hat(phi: torch.Tensor) -> torch.Tensor:
    """so(3) hat: (..., 3) -> (..., 3, 3)."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def _eye_like(K):
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula with small-angle Taylor guard."""
    theta2 = torch.sum(phi * phi, dim=-1)
    small = theta2 < _EPS
    theta2s = torch.where(small, torch.ones_like(theta2), theta2)
    thetas = torch.sqrt(theta2s)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(thetas) / thetas)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(thetas)) / theta2s)
    K = hat(phi)
    return _eye_like(K) + a[..., None, None] * K + b[..., None, None] * _mm(K, K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Inverse Rodrigues; returns (..., 3).  Degrades near theta == pi, which
    the windowed VO never composes in one step."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.acos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0))
    vee = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], dim=-1)
    small = theta < _EPS
    sin_theta = torch.sin(theta)
    sin_safe = torch.where(small, torch.ones_like(sin_theta), sin_theta)
    scale = torch.where(small, 0.5 + theta * theta / 12.0, theta / (2.0 * sin_safe))
    return scale[..., None] * vee


def _V(phi):
    """Left Jacobian of SO(3) (the 'V' matrix in SE3 exp)."""
    theta2 = torch.sum(phi * phi, dim=-1)
    small = theta2 < _EPS
    theta2s = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2s)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2s)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2s * theta))
    K = hat(phi)
    return _eye_like(K) + b[..., None, None] * K + c[..., None, None] * _mm(K, K)


def _V_inv(phi):
    theta2 = torch.sum(phi * phi, dim=-1)
    small = theta2 < _EPS
    theta2s = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2s)
    half = theta * 0.5
    cot = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                      (1.0 - half * torch.cos(half) / torch.sin(half)) / theta2s)
    K = hat(phi)
    return _eye_like(K) - 0.5 * K + cot[..., None, None] * _mm(K, K)


def exp(xi: torch.Tensor) -> torch.Tensor:
    """xi (..., 6) = [rho, phi] -> (..., 3, 4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    return from_Rt(so3_exp(phi), _mv(_V(phi), rho))


def log(T: torch.Tensor) -> torch.Tensor:
    phi = so3_log(rotation(T))
    rho = _mv(_V_inv(phi), translation(T))
    return torch.cat([rho, phi], dim=-1)

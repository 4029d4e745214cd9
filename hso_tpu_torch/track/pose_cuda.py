"""Motion-only pose LM trial loop: CUDA kernel K5 and its plain version.

Counterpart of the JAX package's ``track/pose_pallas.py`` (``pose_lm_tpu``):
Nielsen-damped LM on the unit-plane reprojection error — point residuals
and edgelet residuals projected on the gradient, split robust scales,
TEMPORARY points weighted ×0.5, 6×6 normal equations over all observations,
at most 5 damping trials per iteration.  Device code: ``csrc/pose.cu``.  The
robust-scale setup and the post-solve stripping stay in
:mod:`hso_tpu_torch.track.pose_optimizer`.  Dispatch rule: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from hso_tpu_torch.math import se3
from hso_tpu_torch.math.linalg_small import solve_spd_small
from hso_tpu_torch.math.robust import huber_weight

EPS = 1e-10
MAX_TRIALS = 5
LAUNCHES = {"pose_lm": 0}


def project2d(p):
    z = torch.where(torch.abs(p[..., 2]) < 1e-12, torch.full_like(p[..., 2], 1e-12), p[..., 2])
    return p[..., :2] / z[..., None]


def jacobian_uv_xi(xyz):
    x, y = xyz[..., 0], xyz[..., 1]
    z = xyz[..., 2]
    zi = 1.0 / torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
    zi2 = zi * zi
    zero = torch.zeros_like(x)
    row0 = torch.stack([-zi, zero, x * zi2, x * y * zi2, -(1.0 + x * x * zi2), y * zi], dim=-1)
    row1 = torch.stack([zero, -zi, y * zi2, 1.0 + y * y * zi2, -x * y * zi2, -x * zi], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def residuals(T_e, p_world, obs_uv, grad, sqrt_inv_cov, is_edgelet):
    """(p_t, e (N,2), r_edge, r_abs) of the scaled unit-plane reprojection."""
    p_t = se3.apply(T_e, p_world)
    e = (obs_uv - project2d(p_t)) * sqrt_inv_cov[:, None]
    r_edge = torch.sum(grad * e, dim=-1)
    r_corner = torch.linalg.norm(e, dim=-1)
    r_abs = torch.where(is_edgelet, torch.abs(r_edge), r_corner)
    return p_t, e, r_edge, r_abs


def pose_lm_plain(T0, p_world, obs_uv, grad, sqrt_inv_cov, is_edgelet, is_temporary,
                  valid, scale_pt, scale_ls, n_iter: int = 12, reuse_system: bool = False):
    """LM trial loop in plain PyTorch.  Returns (T (3,4), A_last (6,6),
    chi2_final, n_trials).  One host sync per trial (accept / stop tests).
    With ``reuse_system`` the normal equations are built once per accepted
    pose and kept across rejected trials, as the kernel keeps them; the
    result is the same, since only the damping changes after a reject."""
    zero = torch.zeros_like(sqrt_inv_cov)

    def weights(r_edge, r_abs):
        wgt = torch.where(is_edgelet, huber_weight(torch.abs(r_edge) / scale_ls),
                          huber_weight(r_abs / scale_pt))
        wgt = torch.where(is_temporary, wgt * 0.5, wgt)
        return torch.where(valid, wgt, zero)

    def chi2_of(T_e):
        _, _, r_edge, r_abs = residuals(T_e, p_world, obs_uv, grad, sqrt_inv_cov, is_edgelet)
        wgt = weights(r_edge, r_abs)
        return torch.sum(torch.where(valid, r_abs * r_abs * wgt, zero))

    def system(T_e):
        p_t, e, r_edge, r_abs = residuals(T_e, p_world, obs_uv, grad, sqrt_inv_cov,
                                          is_edgelet)
        wgt = weights(r_edge, r_abs)
        J = jacobian_uv_xi(p_t) * sqrt_inv_cov[:, None, None]          # (N, 2, 6)
        J_edge = torch.sum(grad[..., None] * J, dim=1)                 # (N, 6)
        w_e = torch.where(is_edgelet, wgt, zero)
        w_c = torch.where(is_edgelet, zero, wgt)
        A_e = torch.sum(J_edge[:, :, None] * J_edge[:, None, :] * w_e[:, None, None], dim=0)
        b_e = -torch.sum(J_edge * (r_edge * w_e)[:, None], dim=0)
        A_c = torch.sum(J[:, :, :, None] * J[:, :, None, :] * w_c[:, None, None, None],
                        dim=(0, 1))
        b_c = -torch.sum(J * (e * w_c[:, None])[:, :, None], dim=(0, 1))
        return A_e + A_c, b_e + b_c

    T = T0
    chi2 = chi2_of(T)
    mu = torch.full((), 0.1, dtype=torch.float32, device=T.device)
    nu = torch.full((), 2.0, dtype=torch.float32, device=T.device)
    A_last = torch.zeros((6, 6), dtype=torch.float32, device=T.device)
    n_trials = 0
    stop = False
    built = None                       # the system at the current T, when kept
    for _ in range(n_iter):
        if stop:
            break
        accepted = False
        for _ in range(MAX_TRIALS):
            if built is None or not reuse_system:
                built = system(T)
            A, b = built
            Ad = A + torch.diag(torch.diagonal(A)) * mu
            dT = solve_spd_small(Ad, b)
            ok = torch.all(torch.isfinite(dT))
            dT = torch.where(ok, dT, torch.zeros_like(dT))
            T_new = se3.mul(se3.exp(dT), T)
            chi2_new = chi2_of(T_new)
            rho = torch.where(ok, chi2 - chi2_new, torch.full_like(chi2, -1.0))
            n_trials += 1
            if bool(rho > 0):
                # the raw chi2 decrease feeds the Nielsen update
                T, chi2, A_last, built = T_new, chi2_new, A, None
                mu = mu * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, 1.0 / 3.0, 2.0 / 3.0)
                nu = torch.full_like(nu, 2.0)
                accepted = True
                stop = bool(torch.max(torch.abs(dT)) <= EPS)
                break
            mu = torch.clamp_min(mu * nu, 1e-4)
            nu = nu * 2.0
        stop = stop or not accepted
    return T, A_last, chi2, n_trials


def pose_lm_prepare(T0, p_world, obs_uv, grad, sqrt_inv_cov, is_edgelet, is_temporary,
                    valid, scale_pt, scale_ls, n_iter: int = 12):
    """Check the tensors and prepare one launch of K5: returns ``(launch,
    out)``.  ``launch()`` enqueues ``hso_pose_lm`` on the stream that was
    current here and adds one to the count; ``out`` (64 floats) receives T,
    A_last, chi2 and the trial count.  A timing loop calls ``launch`` again
    and again on the same inputs without the wrapper's tensor work."""
    from hso_tpu_torch import _cuda_build

    _want = _cuda_build.check_tensor
    dev = p_world.device
    n = p_world.shape[0]
    _want(T0, torch.float32, (3, 4), dev, "T0")
    _want(p_world, torch.float32, (n, 3), dev, "p_world")
    _want(obs_uv, torch.float32, (n, 2), dev, "obs_uv")
    _want(grad, torch.float32, (n, 2), dev, "grad")
    _want(sqrt_inv_cov, torch.float32, (n,), dev, "sqrt_inv_cov")
    _want(is_edgelet, torch.bool, (n,), dev, "is_edgelet")
    _want(is_temporary, torch.bool, (n,), dev, "is_temporary")
    _want(valid, torch.bool, (n,), dev, "valid")
    scales = torch.stack([scale_pt.reshape(()), scale_ls.reshape(())]).to(torch.float32)
    out = torch.empty((64,), dtype=torch.float32, device=dev)
    fn = _cuda_build.lib().hso_pose_lm
    # the tuple keeps every tensor the kernel reads alive as long as `launch`
    args = (T0.data_ptr(), p_world.data_ptr(), obs_uv.data_ptr(), grad.data_ptr(),
            sqrt_inv_cov.data_ptr(), is_edgelet.data_ptr(), is_temporary.data_ptr(),
            valid.data_ptr(), scales.data_ptr(), n, n_iter, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    alive = (T0, p_world, obs_uv, grad, sqrt_inv_cov, is_edgelet, is_temporary, valid, scales,
             out)

    def launch(_alive=alive):
        _cuda_build.check(fn(*args), "hso_pose_lm")
        LAUNCHES["pose_lm"] += 1

    return launch, out


def pose_lm_cuda(T0, p_world, obs_uv, grad, sqrt_inv_cov, is_edgelet, is_temporary,
                 valid, scale_pt, scale_ls, n_iter: int = 12):
    """K5: launch ``hso_pose_lm`` on the current stream (one block runs the
    whole trial loop, one fused pass per trial over observations held in
    registers); the arguments of :func:`pose_lm_plain`.  ``n_trials`` comes
    back as a 0-d device tensor."""
    launch, out = pose_lm_prepare(T0, p_world, obs_uv, grad, sqrt_inv_cov, is_edgelet,
                                  is_temporary, valid, scale_pt, scale_ls, n_iter)
    launch()
    return out[:12].reshape(3, 4), out[12:48].reshape(6, 6), out[48], out[49].to(torch.int32)


def pose_lm(T0, p_world, obs_uv, grad, sqrt_inv_cov, is_edgelet, is_temporary,
            valid, scale_pt, scale_ls, n_iter: int = 12):
    """The pose LM trial loop: (T, A_last, chi2_final, n_trials)."""
    if p_world.is_cuda:
        c = torch.Tensor.contiguous
        return pose_lm_cuda(c(T0), c(p_world), c(obs_uv), c(grad), c(sqrt_inv_cov),
                            c(is_edgelet), c(is_temporary), c(valid), scale_pt, scale_ls,
                            n_iter)
    return pose_lm_plain(T0, p_world, obs_uv, grad, sqrt_inv_cov, is_edgelet,
                         is_temporary, valid, scale_pt, scale_ls, n_iter)

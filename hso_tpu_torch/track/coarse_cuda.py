"""Coarse-tracker level LM loop: CUDA kernel K3 and its plain version.

Counterpart of the JAX package's ``track/coarse_pallas.py``
(``coarse_level_ic_tpu``): the whole inverse-compositional LM loop of one
pyramid level — project, bounds mask, pattern samples inside each feature's
24×24 window, Huber/cutoff weights, 7×7 normal equations over all features,
damped Cholesky, SE3 exp, accept/reject, early stop.  Device code:
``csrc/coarse.cu``: one thread-block cluster of 8 blocks runs the level with
each block's features resident in its shared memory (so the kernel needs a
device with cluster launch, compute capability 9.0 or newer).  IC only, for
the cameras whose projection :func:`~hso_tpu_torch.cameras.projection_model`
names (the ideal pinhole, radial-tangential distortion, FOV): the level's
projection goes through the camera's model (``projection=(model,
coefficients)``, ideal by default); the forward-compositional variant runs
the same :func:`lm_level_loop` in plain PyTorch on either device.  Dispatch
rule: a CPU tensor takes the plain version, a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from hso_tpu_torch.cameras.models import PROJECTIONS
from hso_tpu_torch.math import se3
from hso_tpu_torch.math.linalg_small import solve_spd_small
from hso_tpu_torch.ops.gatherless import bilinear_scatter_in_windows, grid_in_window
from hso_tpu_torch.utils.control_flow import gated_loop

WIN = 24
LAUNCHES = {"coarse_level_ic": 0}
IDEAL = ("ideal", ())

#: the launch plan's constants, mirrored from ``csrc/coarse.cu``
CLUSTER = 8               # blocks of the cluster (the portable maximum)
THREADS = 256             # threads of a block; doubled above two items per thread
N_SUMS = 37               # 28 entries of H, 7 of b, the energy, the term count
STATE_FLOATS = 176        # two slots and two totals of N_SUMS, one trial state, padded
SMEM_MAX = 232448         # dynamic shared memory a block may ask for (227 KB)


def coarse_block_bytes(threads: int, feats: int, p: int, resident: bool) -> int:
    """Dynamic shared memory of one block that owns ``feats`` features: the
    reduction buffer, the slots of the cluster-wide sum, the per-item tables
    (a 4-float record and 6 template Jacobian entries per item), points,
    anchors, visibility and, when ``resident``, the 24×24 windows."""
    floats = ((N_SUMS * (threads // 32) + 3) // 4 * 4 + STATE_FLOATS
              + (feats * WIN * WIN if resident else 0) + feats * p * 10 + feats * 5)
    return (floats * 4 + feats + 15) // 16 * 16


def coarse_launch_plan(n: int, p: int) -> tuple:
    """The launch of K3 for ``n`` features with ``p`` pattern points, from the
    shape alone: ``(cluster, threads, resident, smem_bytes)``.  Block ``r`` of
    the cluster owns features ``[r·F, min(n, (r+1)·F))`` with ``F = ⌈n/cluster⌉``
    (a block may own none).  ``resident`` says whether a block's windows fit
    its shared memory beside the tables; if not, the same kernel reads the
    windows from global memory.  Raises if even that does not fit."""
    feats = -(-n // CLUSTER)
    threads = 2 * THREADS if feats * p > 2 * THREADS else THREADS
    resident = coarse_block_bytes(threads, feats, p, True) <= SMEM_MAX
    smem = coarse_block_bytes(threads, feats, p, resident)
    if smem > SMEM_MAX:
        raise ValueError(f"coarse level of {n} features x {p} points needs {smem} bytes of "
                         f"shared memory per block, more than {SMEM_MAX}")
    return CLUSTER, threads, resident, smem


_PATTERNS_ON = {}


def _pattern_tensor(pattern, device) -> torch.Tensor:
    """The pattern's offsets as a (P, 2) float32 tensor on ``device``, copied
    there once (a copy from the host waits for the device)."""
    key = (tuple(map(tuple, pattern)), str(device))
    if key not in _PATTERNS_ON:
        _PATTERNS_ON[key] = torch.as_tensor(key[0], dtype=torch.float32, device=device)
    return _PATTERNS_ON[key]


def pattern_samples(windows, rel_u, rel_v, center: int, pattern, with_grad: bool):
    """Pattern values (N, P) [+ central-difference gradients] sampled inside
    each window; ``rel_u/rel_v`` locate grid point (0, 0), the pattern centre
    sits at grid point (center, center)."""
    pat = _pattern_tensor(pattern, windows.device)                         # (P, 2)
    pu = rel_u[:, None] + (center + pat[:, 0])[None, :]
    pv = rel_v[:, None] + (center + pat[:, 1])[None, :]
    if not with_grad:
        return bilinear_scatter_in_windows(windows, pu, pv), None, None
    p = pat.shape[0]
    allu = torch.cat([pu, pu + 1.0, pu - 1.0, pu, pu], dim=1)
    allv = torch.cat([pv, pv, pv, pv + 1.0, pv - 1.0], dim=1)
    s = bilinear_scatter_in_windows(windows, allu, allv)
    vals = s[:, :p]
    gx = 0.5 * (s[:, p:2 * p] - s[:, 2 * p:3 * p])
    gy = 0.5 * (s[:, 3 * p:4 * p] - s[:, 4 * p:])
    return vals, gx, gy


def robust_system(cur_vals, ref_patch, J_T, a_e, valid, huber, cutoff, is_top: bool):
    """(E_norm, H 7×7, b 7, n_terms) of the photometric residuals
    ``cur - a·ref`` with Huber weights and (below the top level) cutoff
    saturation.  ``J_T`` (N, P, 6) is the pose Jacobian; the exposure column
    is ``-ref``."""
    r = cur_vals - a_e * ref_patch                                          # (N, P)
    m = valid[:, None].expand_as(r)
    abs_r = torch.abs(r)
    hw = torch.where(abs_r < huber, torch.ones_like(r),
                     huber / torch.clamp_min(abs_r, 1e-12))
    if is_top:
        saturated = torch.zeros_like(m)
        e_terms = hw * r * r
    else:
        saturated = (abs_r > cutoff) & m
        max_energy = 2.0 * huber * cutoff - huber * huber
        e_terms = torch.where(saturated, max_energy, hw * r * r * (2.0 - hw))
    zero = torch.zeros_like(r)
    E = torch.sum(torch.where(m, e_terms, zero))
    n_terms = torch.sum(m.to(torch.int32)).to(torch.int32)
    wgt = torch.where(m & ~saturated, hw, zero)
    J7 = torch.cat([-ref_patch[..., None], J_T], dim=-1).reshape(-1, 7)
    Jw = J7 * wgt.reshape(-1)[:, None]
    H = torch.sum(Jw[:, :, None] * J7[:, None, :], dim=0)
    b = -torch.sum(Jw * r.reshape(-1)[:, None], dim=0)
    E_norm = E / torch.clamp_min(n_terms, 1).to(torch.float32)
    return E_norm, H, b, n_terms


def lm_level_loop(evaluate, T, a, n_iter: int, inverse: bool):
    """Levenberg-Marquardt over [exposure ratio; se3] with extrapolated
    steps.  ``evaluate(T, a) -> (E_norm, H, b, n_terms)``.  Returns (T, a,
    E_norm, n_terms, iters).

    The JAX tracker's ``lax.while_loop`` (``hso_tpu/track/coarse_tracker.py:
    260-290``) as :func:`~hso_tpu_torch.utils.control_flow.gated_loop`: at
    most ``n_iter`` iterations, each gated by the device flag ``(it < n_iter)
    & ~stop``; the state is updated in place and ``iters`` counted on the
    device.  The host reads the flag once an iteration (on the card a wait);
    in a captured step each iteration is an IF node and nothing waits."""
    E_c, H_c, b_c, nt_c = evaluate(T, a)
    dev = T.device
    T = T.clone()
    a = a.clone()
    lam = torch.full((), 0.1, dtype=torch.float32, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    active = torch.ones((), dtype=torch.bool, device=dev)

    def body():
        Hl = H_c + torch.diag(torch.diagonal(H_c)) * lam
        step = solve_spd_small(Hl, b_c)
        extrap = torch.where(lam < 1e-3, torch.sqrt(torch.sqrt(1e-3 / lam)),
                             torch.ones_like(lam))
        step = step * extrap
        step = torch.where(torch.all(torch.isfinite(step)), step, torch.zeros_like(step))

        a_new = a + step[0]
        dT = se3.exp(-step[1:7])
        T_new = se3.mul(T, dT) if inverse else se3.mul(dT, T)

        E_new, H_new, b_new, nt_new = evaluate(T_new, a_new)
        accept = E_new < E_c          # False on NaN: select, never blend
        T.copy_(torch.where(accept, T_new, T))
        a.copy_(torch.where(accept, a_new, a))
        E_c.copy_(torch.where(accept, E_new, E_c))
        H_c.copy_(torch.where(accept, H_new, H_c))
        b_c.copy_(torch.where(accept, b_new, b_c))
        nt_c.copy_(torch.where(accept, nt_new, nt_c))
        lam.copy_(torch.where(accept, lam * 0.5, torch.clamp_min(lam * 4.0, 1e-3)))
        it.add_(1)
        active.copy_((it < n_iter) & ~(torch.linalg.norm(step) <= 1e-4))

    gated_loop(n_iter, active, body)
    return T, a, E_c, nt_c, it


def project_level(xyz_cur, fxl: float, fyl: float, cxl: float, cyl: float, projection=IDEAL):
    """Level pixels (u, v) of camera-frame points through the camera's model,
    as K3 computes them (the formulas of ``cameras/models.py``, the
    coefficients as float32)."""
    zc = xyz_cur[:, 2]
    zi = 1.0 / torch.where(torch.abs(zc) < 1e-9, torch.full_like(zc, 1e-9), zc)
    model, coef = projection
    if model == "ideal":
        return fxl * xyz_cur[:, 0] * zi + cxl, fyl * xyz_cur[:, 1] * zi + cyl
    c = [float(np.float32(v)) for v in coef]
    x = xyz_cur[:, 0] * zi
    y = xyz_cur[:, 1] * zi
    if model == "radtan":
        k1, k2, p1, p2, k3 = c
        r2 = x * x + y * y
        r4 = r2 * r2
        r6 = r4 * r2
        a1 = 2.0 * x * y
        a2 = r2 + 2.0 * x * x
        a3 = r2 + 2.0 * y * y
        cdist = 1.0 + k1 * r2 + k2 * r4 + k3 * r6
        xd = x * cdist + p1 * a1 + p2 * a2
        yd = y * cdist + p1 * a3 + p2 * a1
    elif model == "fov":
        omega, two_tan = c[:2]
        r = torch.sqrt(x * x + y * y)
        rs = torch.clamp_min(r, 1e-12)
        fac = torch.where(r < 1e-12, torch.ones_like(r),
                          torch.atan(rs * two_tan) / (rs * omega))
        xd = fac * x
        yd = fac * y
    else:
        raise ValueError(f"K3 has no projection model {model!r}")
    return fxl * xd + cxl, fyl * yd + cyl


def coarse_level_ic_plain(w_cur, ref_patch, j_ic, xyz_ref, au_c, av_c, vis, T0, a0,
                          huber, cutoff, fxl: float, fyl: float, cxl: float, cyl: float,
                          g: int, center: int, pattern: tuple, n_iter: int, is_top: bool,
                          border: int, h_img: int, w_img: int, projection=IDEAL):
    """One coarse level (IC) in plain PyTorch, projecting through
    ``projection`` (:func:`project_level`).  Returns (T (3,4), a, E_norm,
    n_terms, iters); ``n_terms`` counts residuals, not features."""
    au_f = au_c.to(torch.float32)
    av_f = av_c.to(torch.float32)

    def evaluate(T_e, a_e):
        xyz_cur = se3.apply(T_e, xyz_ref)
        zc = xyz_cur[:, 2]
        u, v = project_level(xyz_cur, fxl, fyl, cxl, cyl, projection)
        rel_u = u - center - au_f
        rel_v = v - center - av_f
        uf = torch.floor(u)
        vf = torch.floor(v)
        valid = (vis & (zc > 0.0) & grid_in_window(rel_u, rel_v, g, WIN)
                 & (uf - border >= 0) & (vf - border >= 0)
                 & (uf + border < w_img) & (vf + border < h_img))
        cur_vals, _, _ = pattern_samples(w_cur, rel_u, rel_v, center, pattern, False)
        return robust_system(cur_vals, ref_patch, a_e * j_ic, a_e, valid,
                             huber, cutoff, is_top)

    return lm_level_loop(evaluate, T0, a0, n_iter, inverse=True)


def coarse_level_ic_prepare(w_cur, ref_patch, j_ic, xyz_ref, au_c, av_c, vis, T0, a0,
                            huber, cutoff, fxl: float, fyl: float, cxl: float, cyl: float,
                            g: int, center: int, pattern: tuple, n_iter: int, is_top: bool,
                            border: int, h_img: int, w_img: int, projection=IDEAL):
    """Check the tensors and prepare one launch of K3: returns ``(launch,
    out)``.  ``launch()`` enqueues ``hso_coarse_level_ic`` (the ideal pinhole)
    or ``hso_coarse_level_ic_model`` (another model, with its coefficients)
    on the stream that was current here and adds one to the count; ``out``
    (16 floats) receives T, a, E_norm, n_terms, iterations.  A timing loop
    calls ``launch`` again and again on the same inputs without the wrapper's
    tensor work."""
    from hso_tpu_torch import _cuda_build

    _want = _cuda_build.check_tensor
    dev = w_cur.device
    n, p = ref_patch.shape
    if p != len(pattern) or p > _cuda_build.PatternTable.MAX_POINTS:
        raise ValueError(f"pattern of {len(pattern)} points does not fit ref_patch {p}")
    coarse_launch_plan(n, p)                 # raises on a shape the kernel does not take
    _want(w_cur, torch.float32, (n, WIN, WIN), dev, "w_cur")
    _want(ref_patch, torch.float32, (n, p), dev, "ref_patch")
    _want(j_ic, torch.float32, (n, p, 6), dev, "j_ic")
    _want(xyz_ref, torch.float32, (n, 3), dev, "xyz_ref")
    _want(au_c, torch.int32, (n,), dev, "au_c")
    _want(av_c, torch.int32, (n,), dev, "av_c")
    _want(vis, torch.bool, (n,), dev, "vis")
    _want(T0, torch.float32, (3, 4), dev, "T0")
    sc = torch.stack([a0.reshape(()), huber.reshape(()), cutoff.reshape(())]).to(torch.float32)
    table = _cuda_build.PatternTable()
    for k, (dx, dy) in enumerate(pattern):
        table.dx[k], table.dy[k] = int(dx), int(dy)
    model, coef = projection
    if model not in PROJECTIONS or len(coef) > 5:
        raise ValueError(f"K3 has no projection model {model!r} with {len(coef)} coefficients")
    out = torch.empty((16,), dtype=torch.float32, device=dev)
    # the tuple keeps every tensor the kernel reads alive as long as `launch`
    args = [w_cur.data_ptr(), ref_patch.data_ptr(), j_ic.data_ptr(), xyz_ref.data_ptr(),
            au_c.data_ptr(), av_c.data_ptr(), vis.data_ptr(), T0.data_ptr(), sc.data_ptr(),
            fxl, fyl, cxl, cyl, n, p, g, center, ctypes.byref(table),
            n_iter, int(is_top), border, h_img, w_img]
    if model == "ideal":
        name = "hso_coarse_level_ic"
    else:
        name = "hso_coarse_level_ic_model"
        args += [PROJECTIONS[model], *(tuple(coef) + (0.0,) * (5 - len(coef)))]
    args += [out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream]
    fn = getattr(_cuda_build.lib(), name)
    alive = (w_cur, ref_patch, j_ic, xyz_ref, au_c, av_c, vis, T0, sc, table, out)

    def launch(_alive=alive):
        _cuda_build.check(fn(*args), name)
        LAUNCHES["coarse_level_ic"] += 1

    return launch, out


def coarse_level_ic_cuda(w_cur, ref_patch, j_ic, xyz_ref, au_c, av_c, vis, T0, a0,
                         huber, cutoff, fxl: float, fyl: float, cxl: float, cyl: float,
                         g: int, center: int, pattern: tuple, n_iter: int, is_top: bool,
                         border: int, h_img: int, w_img: int, projection=IDEAL):
    """K3: launch ``hso_coarse_level_ic`` on the current stream (one cluster
    of blocks runs the whole level loop, :func:`coarse_launch_plan`); the
    arguments of :func:`coarse_level_ic_plain`.  No host sync:
    ``a0``/``huber``/``cutoff`` travel as a small device tensor."""
    launch, out = coarse_level_ic_prepare(
        w_cur, ref_patch, j_ic, xyz_ref, au_c, av_c, vis, T0, a0, huber, cutoff,
        fxl, fyl, cxl, cyl, g, center, pattern, n_iter, is_top, border, h_img, w_img,
        projection)
    launch()
    return (out[:12].reshape(3, 4), out[12], out[13],
            out[14].to(torch.int32), out[15].to(torch.int32))


def coarse_level_ic(w_cur, ref_patch, j_ic, xyz_ref, au_c, av_c, vis, T0, a0,
                    huber, cutoff, *args, **kwargs):
    """One coarse-tracker level (IC): (T, a, E_norm, n_terms, iters)."""
    if w_cur.is_cuda:
        c = torch.Tensor.contiguous
        return coarse_level_ic_cuda(c(w_cur), c(ref_patch), c(j_ic), c(xyz_ref), c(au_c),
                                    c(av_c), c(vis), c(T0), a0, huber, cutoff,
                                    *args, **kwargs)
    return coarse_level_ic_plain(w_cur, ref_patch, j_ic, xyz_ref, au_c, av_c, vis, T0, a0,
                                 huber, cutoff, *args, **kwargs)

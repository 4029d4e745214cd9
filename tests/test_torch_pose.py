"""Port ↔ JAX parity of the motion-only pose optimizer (CPU).

``optimize_pose`` against the JAX function, and the plain version of kernel
K5 against the JAX kernel ``pose_lm_tpu`` in Pallas interpret mode.
Tolerances: T 5e-4 (|log| of the relative transform), ``err_final_px``
within 5 %, inlier masks agreeing on ≥ 95 % of slots (a residual at the
threshold may fall either way); the Nielsen accept test ``rho > 0`` flips on
rounding near convergence, so the result is held, not the trial count.
The kernel builds the normal equations once per accepted pose and keeps them
across rejected trials; the plain version pins that this changes nothing.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hso_tpu.ops import window_pallas
from hso_tpu.track.pose_optimizer import optimize_pose as jax_optimize_pose
from hso_tpu_torch import testing
from hso_tpu_torch.math import se3np
from hso_tpu_torch.track import pose_cuda
from hso_tpu_torch.track.pose_optimizer import optimize_pose

torch.set_num_threads(1)

t = torch.as_tensor
KEYS = ("T0", "p_world", "f_obs", "level", "grad", "is_edge", "is_temp", "valid")


@contextlib.contextmanager
def forced_interpret():
    window_pallas.force_interpret(True)
    jax.clear_caches()
    try:
        yield
    finally:
        window_pallas.force_interpret(False)
        jax.clear_caches()


def _se3_dist(Ta, Tb):
    return np.linalg.norm(se3np.log(se3np.mul(np.asarray(Ta, np.float64),
                                              se3np.inv(np.asarray(Tb, np.float64)))))


@pytest.mark.parametrize("n,n_live", [(256, 180), (96, 60)])
def test_optimize_pose_matches_jax(n, n_live):
    pb = testing.pose_problem(n, n_live)
    ref = jax.tree.map(np.asarray, jax_optimize_pose(*(jnp.asarray(pb[k]) for k in KEYS),
                                                     focal=400.0))
    before = dict(pose_cuda.LAUNCHES)
    out = optimize_pose(*(t(pb[k]) for k in KEYS), focal=400.0)
    assert pose_cuda.LAUNCHES == before                 # CPU tensors: the plain version
    for r in (ref["T_f_w"], out["T_f_w"].numpy()):
        assert _se3_dist(r, pb["T_true"]) < 6e-3
    assert _se3_dist(out["T_f_w"].numpy(), ref["T_f_w"]) < 5e-4
    agree = (out["inlier"].numpy() == ref["inlier"]).mean()
    assert agree >= 0.95, agree
    assert not out["inlier"][n_live - 3] and not ref["inlier"][n_live - 3]
    np.testing.assert_allclose(float(out["err_final_px"]), float(ref["err_final_px"]),
                               rtol=0.05, atol=1e-3)
    np.testing.assert_allclose(float(out["err_init_px"]), float(ref["err_init_px"]), rtol=1e-4)
    np.testing.assert_allclose(float(out["scale_px"]), float(ref["scale_px"]), rtol=1e-4)
    assert abs(int(out["n_inliers"]) - int(ref["n_inliers"])) <= 0.05 * n
    assert out["cov"].shape == (6, 6) and bool(torch.isfinite(out["cov"]).all())


def test_optimize_pose_empty_mask_returns_T0():
    n = 128
    z = np.zeros(n, np.float32)
    args = (se3np.identity().astype(np.float32), np.zeros((n, 3), np.float32),
            np.tile([0.0, 0.0, 1.0], (n, 1)).astype(np.float32), np.zeros(n, np.int32),
            np.zeros((n, 2), np.float32), z > 1, z > 1, z > 1)
    ref = jax.tree.map(np.asarray, jax_optimize_pose(*(jnp.asarray(a) for a in args), focal=400.0))
    out = optimize_pose(*(t(a) for a in args), focal=400.0)
    np.testing.assert_allclose(ref["T_f_w"], args[0], atol=1e-6)
    np.testing.assert_allclose(out["T_f_w"].numpy(), args[0], atol=1e-6)
    assert int(out["n_inliers"]) == 0 == int(ref["n_inliers"])


def test_pose_lm_plain_matches_jax_kernel():
    from hso_tpu.track.pose_pallas import pose_lm_tpu

    pb = testing.pose_problem(128, 100, seed=12)
    obs_uv = (pb["f_obs"][:, :2] / pb["f_obs"][:, 2:3]).astype(np.float32)
    sic = (1.0 / (1 << pb["level"])).astype(np.float32)
    scale_pt, scale_ls = np.float32(1.2e-3), np.float32(9e-4)
    args = (pb["T0"], pb["p_world"], obs_uv, pb["grad"], sic, pb["is_edge"], pb["is_temp"],
            pb["valid"], scale_pt, scale_ls)
    with forced_interpret():
        ref = [np.asarray(r) for r in pose_lm_tpu(*(jnp.asarray(a) for a in args), n_iter=12)]
    T, A_last, chi2, n_trials = pose_cuda.pose_lm(*(t(a) for a in args), n_iter=12)
    assert _se3_dist(T.numpy(), ref[0]) < 5e-4
    assert _se3_dist(T.numpy(), pb["T_true"]) < 6e-3
    np.testing.assert_allclose(float(chi2), float(ref[2]), rtol=0.05)
    np.testing.assert_allclose(A_last.numpy(), ref[1], rtol=0.05, atol=1e-3 * np.abs(ref[1]).max())
    assert 1 <= int(n_trials) <= 60


@pytest.mark.parametrize("n,n_live,seed,far", [(128, 100, 12, False), (256, 180, 3, False),
                                               (96, 60, 5, True)])
def test_pose_lm_plain_reused_system_equals_rebuilt(n, n_live, seed, far):
    """The contract K5's fused pass relies on: after a rejected trial only the
    damping changes, so the system kept from the last accepted pose gives the
    same ``T``, ``A_last``, chi2 and trial count, bit for bit, as one rebuilt
    before every trial."""
    pb = testing.pose_problem(n, n_live, seed=seed)
    obs_uv = (pb["f_obs"][:, :2] / pb["f_obs"][:, 2:3]).astype(np.float32)
    sic = (1.0 / (1 << pb["level"])).astype(np.float32)
    T0 = pb["T0"].copy()
    if far:
        T0[0, 3] += 0.3                 # a start that needs rejected trials on the way
    args = [t(a) for a in (T0, pb["p_world"], obs_uv, pb["grad"], sic, pb["is_edge"],
                           pb["is_temp"], pb["valid"], np.float32(1.2e-3), np.float32(9e-4))]
    rebuilt = pose_cuda.pose_lm_plain(*args, n_iter=12)
    reused = pose_cuda.pose_lm_plain(*args, n_iter=12, reuse_system=True)
    for a, b in zip(rebuilt[:3], reused[:3]):
        assert torch.equal(a, b)
    assert rebuilt[3] == reused[3]
    # the loop ends on an iteration whose five trials were all rejected (or on
    # its iteration limit), so rejected trials are part of every run
    assert rebuilt[3] >= 6 or rebuilt[3] == 12
    assert bool(torch.isfinite(reused[0]).all()) and float(reused[1].abs().max()) > 0

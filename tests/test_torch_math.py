"""Port ↔ JAX parity of the math and camera leaves (CPU).

The same numpy inputs go through ``hso_tpu.math`` / ``hso_tpu.cameras`` and
their ``hso_tpu_torch`` counterparts.  Tolerance 1e-6 unless stated: both
sides evaluate the same float32 formulas, so they differ by rounding only.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hso_tpu.cameras import PinholeCamera as JaxPinhole
from hso_tpu.math import linalg_small as j_linalg
from hso_tpu.math import robust as j_robust
from hso_tpu.math import se3 as j_se3
from hso_tpu_torch.cameras import PinholeCamera as TorchPinhole
from hso_tpu_torch.math import linalg_small as t_linalg
from hso_tpu_torch.math import robust as t_robust
from hso_tpu_torch.math import se3 as t_se3
from hso_tpu_torch.math import se3np as t_se3np

torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.array(x))


def _xi(seed, n=32, small=False):
    rs = np.random.RandomState(seed)
    xi = rs.uniform(-1.0, 1.0, (n, 6)).astype(np.float32)
    if small:
        xi[:, 3:] *= 1e-4          # exercises the Taylor branch
    return xi


@pytest.mark.parametrize("small", [False, True])
def test_se3_exp_log(small):
    xi = _xi(0, small=small)
    T_j = np.asarray(j_se3.exp(jnp.asarray(xi)))
    T_t = t_se3.exp(_t(xi)).numpy()
    np.testing.assert_allclose(T_t, T_j, atol=1e-6)
    np.testing.assert_allclose(t_se3.log(_t(T_j)).numpy(), np.asarray(j_se3.log(jnp.asarray(T_j))),
                               atol=2e-6)
    # the float64 numpy instance agrees with the float32 tensor one
    np.testing.assert_allclose(t_se3np.exp(xi.astype(np.float64)), T_t, atol=1e-5)


def test_se3_mul_inv_apply():
    A = np.asarray(j_se3.exp(jnp.asarray(_xi(1))))
    B = np.asarray(j_se3.exp(jnp.asarray(_xi(2))))
    p = np.random.RandomState(3).uniform(-2, 2, (32, 3)).astype(np.float32)
    np.testing.assert_allclose(t_se3.mul(_t(A), _t(B)).numpy(),
                               np.asarray(j_se3.mul(jnp.asarray(A), jnp.asarray(B))), atol=1e-6)
    np.testing.assert_allclose(t_se3.inv(_t(A)).numpy(), np.asarray(j_se3.inv(jnp.asarray(A))),
                               atol=1e-6)
    np.testing.assert_allclose(t_se3.apply(_t(A), _t(p)).numpy(),
                               np.asarray(j_se3.apply(jnp.asarray(A), jnp.asarray(p))), atol=1e-6)
    # a single transform broadcasts over points, as the pipeline uses it
    np.testing.assert_allclose(t_se3.apply(_t(A[0]), _t(p)).numpy(),
                               np.asarray(j_se3.apply(jnp.asarray(A[0]), jnp.asarray(p))),
                               atol=1e-6)
    np.testing.assert_allclose(t_se3.translation(_t(A)).numpy(), A[:, :, 3])
    np.testing.assert_allclose(
        t_se3.from_Rt(t_se3.rotation(_t(A)), t_se3.translation(_t(A))).numpy(), A)


@pytest.mark.parametrize("n", [6, 7])
def test_solve_spd_small(n):
    rs = np.random.RandomState(4)
    M = rs.normal(size=(5, n, n)).astype(np.float32)
    A = M @ np.swapaxes(M, -1, -2) + 0.5 * np.eye(n, dtype=np.float32)
    b = rs.normal(size=(5, n)).astype(np.float32)
    x_j = np.asarray(j_linalg.solve_spd_small(jnp.asarray(A), jnp.asarray(b)))
    x_t = t_linalg.solve_spd_small(_t(A), _t(b)).numpy()
    # 1e-5: the substitution chains amplify the last-bit differences
    np.testing.assert_allclose(x_t, x_j, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(np.einsum("bij,bj->bi", A, x_t), b, atol=1e-3)


def test_solve_spd_small_bad_pivot_is_nan():
    A = np.diag([1.0, -2.0, 3.0]).astype(np.float32)
    b = np.ones(3, np.float32)
    x_j = np.asarray(j_linalg.solve_spd_small(jnp.asarray(A), jnp.asarray(b)))
    x_t = t_linalg.solve_spd_small(_t(A), _t(b)).numpy()
    assert np.isnan(x_j).any() and np.isnan(x_t).any()
    np.testing.assert_array_equal(np.isnan(x_t), np.isnan(x_j))


def test_small_inverses():
    rs = np.random.RandomState(5)
    A2 = rs.normal(size=(16, 2, 2)).astype(np.float32)
    A3 = rs.normal(size=(16, 3, 3)).astype(np.float32)
    A2[0] = 0.0                      # singular: the determinant guard
    for jf, tf, A in ((j_linalg.inv2x2, t_linalg.inv2x2, A2),
                      (j_linalg.inv3x3, t_linalg.inv3x3, A3)):
        ref = np.asarray(jf(jnp.asarray(A)))
        np.testing.assert_allclose(tf(_t(A)).numpy(), ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max())
    np.testing.assert_allclose(t_linalg.det2x2(_t(A2)).numpy(),
                               np.asarray(j_linalg.det2x2(jnp.asarray(A2))), atol=1e-6)


@pytest.mark.parametrize("n_valid", [0, 1, 6, 7, 20])
def test_masked_median_is_upper_median(n_valid):
    rs = np.random.RandomState(6)
    v = rs.normal(size=20).astype(np.float32)
    m = np.zeros(20, bool)
    m[rs.permutation(20)[:n_valid]] = True
    ref = float(j_robust.masked_median(jnp.asarray(v), jnp.asarray(m)))
    got = float(t_robust.masked_median(_t(v), _t(m)))
    assert got == ref
    expect = np.sort(v[m])[n_valid // 2] if n_valid else 0.0
    assert got == np.float32(expect)


def test_mad_and_huber():
    rs = np.random.RandomState(7)
    v = np.abs(rs.normal(size=50)).astype(np.float32)
    m = rs.rand(50) < 0.7
    for jf, tf in ((j_robust.masked_mad_sigma, t_robust.masked_mad_sigma),
                   (j_robust.mad_scale_of_abs, t_robust.mad_scale_of_abs)):
        np.testing.assert_allclose(float(tf(_t(v), _t(m))),
                                   float(jf(jnp.asarray(v), jnp.asarray(m))), atol=1e-6)
    x = rs.normal(scale=2.0, size=50).astype(np.float32)
    np.testing.assert_allclose(t_robust.huber_weight(_t(x)).numpy(),
                               np.asarray(j_robust.huber_weight(jnp.asarray(x))), atol=1e-6)


@pytest.mark.parametrize("dist", [(0.0,) * 5, (-0.28, 0.07, 2e-4, 1e-5, 0.0)])
def test_camera_round_trip(dist):
    cj = JaxPinhole(640, 480, 400.0, 410.0, 320.0, 240.0, *dist)
    ct = TorchPinhole(640, 480, 400.0, 410.0, 320.0, 240.0, *dist)
    assert ct.focal_mean == cj.focal_mean
    rs = np.random.RandomState(8)
    px = np.stack([rs.uniform(0, 640, 64), rs.uniform(0, 480, 64)], -1).astype(np.float32)
    f_j = np.asarray(cj.cam2world(jnp.asarray(px)))
    f_t = ct.cam2world(_t(px))
    np.testing.assert_allclose(f_t.numpy(), f_j, atol=1e-6)
    px_back = ct.world2cam(f_t * 3.0).numpy()
    np.testing.assert_allclose(px_back, np.asarray(cj.world2cam(jnp.asarray(f_j) * 3.0)),
                               atol=1e-3)
    np.testing.assert_allclose(px_back, px, atol=5e-2)
    np.testing.assert_array_equal(ct.is_in_frame(_t(px), border=8).numpy(),
                                  np.asarray(cj.is_in_frame(jnp.asarray(px), border=8)))
    # numpy in, numpy out (host bookkeeping, scene rendering)
    assert isinstance(ct.cam2world(px.astype(np.float64)), np.ndarray)


@pytest.mark.parametrize("n_valid", [0, 1, 6, 7, 200])
def test_masked_median_bisect(n_valid):
    """Bisection converges to the upper median within (max − min) / 2^30; a
    non-finite entry under the mask is left out on both sides."""
    rs = np.random.RandomState(10 + n_valid)
    n = 256
    v = rs.normal(scale=3.0, size=n).astype(np.float32)
    m = np.zeros(n, bool)
    m[rs.permutation(n)[:n_valid]] = True
    if n_valid >= 6:
        v[np.nonzero(m)[0][0]] = np.inf
    got = float(t_robust.masked_median_bisect(_t(v), _t(m)))
    ref = float(j_robust.masked_median_bisect(jnp.asarray(v), jnp.asarray(m)))
    np.testing.assert_allclose(got, ref, atol=1e-6)
    live = v[m & np.isfinite(v)]
    if len(live):
        np.testing.assert_allclose(got, np.sort(live)[len(live) // 2], atol=1e-5)
    else:
        assert got == 0.0


def test_tukey_weight():
    x = np.linspace(-8.0, 8.0, 101).astype(np.float32)
    got = t_robust.tukey_weight(_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_robust.tukey_weight(jnp.asarray(x))), atol=1e-7)
    assert got[50] == 1.0 and got[0] == 0.0 and got[-1] == 0.0


def _fov_pair(undistort_image):
    from hso_tpu.cameras import FOVCamera as JaxFOV
    from hso_tpu_torch.cameras import FOVCamera

    args = (640, 480, 0.535719308086809, 0.669566858850269, 0.493248545285398,
            0.500408664348414, 0.897966326944875)
    return (JaxFOV(*args, undistort_image=undistort_image),
            FOVCamera(*args, undistort_image=undistort_image))


@pytest.mark.parametrize("undistort_image", [False, True])
def test_fov_camera(undistort_image):
    """ATAN model with normalised intrinsics: the per-point warp when live,
    the ideal pinhole over rectified images otherwise."""
    cj, ct = _fov_pair(undistort_image)
    assert (ct.fx, ct.fy, ct.cx, ct.cy) == (cj.fx, cj.fy, cj.cx, cj.cy)
    assert ct.has_distortion == cj.has_distortion == (not undistort_image)
    rs = np.random.RandomState(9)
    px = np.stack([rs.uniform(0, 640, 64), rs.uniform(0, 480, 64)], -1).astype(np.float32)
    px[0] = [ct.cx, ct.cy]                         # the centre: r = 0 guard
    f_j = np.asarray(cj.cam2world(jnp.asarray(px)))
    f_t = ct.cam2world(_t(px))
    np.testing.assert_allclose(f_t.numpy(), f_j, atol=1e-6)
    back = ct.world2cam(f_t * 2.0).numpy()
    np.testing.assert_allclose(back, np.asarray(cj.world2cam(jnp.asarray(f_j) * 2.0)), atol=1e-3)
    np.testing.assert_allclose(back, px, atol=1e-2)
    # numpy in, numpy out, float64
    f_np = ct.cam2world(px.astype(np.float64))
    assert isinstance(f_np, np.ndarray)
    np.testing.assert_allclose(f_np, cj.cam2world(px.astype(np.float64)), atol=1e-12)
    for a, b in zip(ct.undistort_remap(), cj.undistort_remap()):
        assert a.dtype == np.float32 and a.shape == (480, 640)
        np.testing.assert_allclose(a, b, atol=1e-4)
    ideal = ct.ideal()
    assert (ideal.fx, ideal.cy) == (ct.fx, ct.cy)
    np.testing.assert_allclose(ideal.cam2world(px), cj.ideal().cam2world(px), atol=1e-7)


def test_equidistant_camera():
    from hso_tpu.cameras import EquidistantCamera as JaxEqui
    from hso_tpu_torch.cameras import EquidistantCamera

    args = (752, 480, 461.6, 460.3, 363.0, 248.1, -0.0027, 0.0244, -0.0433, 0.0207)
    cj, ct = JaxEqui(*args), EquidistantCamera(*args)
    assert ct.undistort_image and not ct.has_distortion and ct.k == cj.k
    for a, b in zip(ct.undistort_remap(), cj.undistort_remap()):
        assert a.dtype == np.float32 and a.shape == (480, 752)
        np.testing.assert_allclose(a, b, atol=1e-4)
    rs = np.random.RandomState(3)
    xy = rs.uniform(-1.0, 1.0, (2, 50)).astype(np.float32)
    xy[:, 0] = 0.0                                 # r = 0 guard
    got = ct._equi_distort(_t(xy[0]), _t(xy[1]))
    ref = cj._equi_distort(jnp.asarray(xy[0]), jnp.asarray(xy[1]))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    # points are ideal pinhole after the remap
    px = np.array([[100.0, 50.0], [363.0, 248.1]], np.float32)
    np.testing.assert_allclose(ct.cam2world(_t(px)).numpy(),
                               np.asarray(cj.cam2world(jnp.asarray(px))), atol=1e-6)

"""Online photometric calibration: the port's ``solve_photometric``,
``correct_image``, ``inverse_response_curve``, ``vignette_map`` and
``OnlinePhotometricCalibrator`` against the JAX package's on the same seeded
inputs (the problems of ``tests/test_photometric.py``).

Tolerances.  ``log_e`` to 1e-4, ``rms_after`` to 1e-5, ``n_obs`` exact.  The
response coefficients ``c`` are held through the curve they define,
Σ c_k φ_k(x) over the usable range 3..252, to 2e-4 (log units), and the
vignette ``v`` through log V(R) on R in [0, 1] to 1e-4: the 7×7 normal matrix
has a condition number near 1.4e6 (the basis xᵏ(1-x) is nearly collinear),
so float32 rounding moves each coefficient by up to a few 1e-2 along the
flat direction (the JAX solve itself lies 0.04 from a float64 solve of the
same problem) while the curve stays put.  ``c`` and ``v`` themselves are held
to that bound, 0.05 and 1e-3.  ``correct_image`` to 1e-3 grey levels.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hso_tpu.photometric import online_calib as J
from hso_tpu_torch.photometric import online_calib as T
from hso_tpu_torch.pipeline.scan import pin_float32_matmul
from test_photometric import _forward, _make_problem

torch.set_num_threads(1)
pin_float32_matmul()

X_USABLE = np.linspace(T.INT_LO / 255.0, T.INT_HI / 255.0, 256)
PHI = np.stack([X_USABLE ** k * (1 - X_USABLE) for k in range(1, T.N_RESP + 1)], -1)
R_GRID = np.linspace(0.0, 1.0, 65)
PSI = np.stack([R_GRID ** m for m in range(1, T.N_VIG + 1)], -1)


def hold_c(cj, ct, curve_tol=2e-4, coef_tol=0.05):
    cj, ct = np.asarray(cj, np.float64), np.asarray(ct, np.float64)
    assert np.abs(PHI @ (cj - ct)).max() <= curve_tol
    assert np.abs(cj - ct).max() <= coef_tol


def hold_v(vj, vt, log_tol=1e-4, coef_tol=1e-3):
    vj, vt = np.asarray(vj, np.float64), np.asarray(vt, np.float64)
    assert np.abs(PSI @ (vj - vt)).max() <= log_tol
    assert np.abs(vj - vt).max() <= coef_tol


def solve_both(seed, **kw):
    obs, r2, valid, log_e, radiance = _make_problem(seed=seed, **kw)
    oj = J.solve_photometric(jnp.asarray(obs, jnp.float32), jnp.asarray(r2, jnp.float32),
                             jnp.asarray(valid))
    ot = T.solve_photometric(torch.from_numpy(obs.astype(np.float32)),
                             torch.from_numpy(r2.astype(np.float32)), torch.from_numpy(valid))
    return {k: np.asarray(v) for k, v in oj.items()}, {k: v.numpy() for k, v in ot.items()}, \
        (obs, r2, valid, log_e)


@pytest.mark.parametrize("seed,kw", [(3, {}), (5, {}), (11, {}), (7, dict(f_n=12, m_n=40)),
                                     (8, dict(drop=0.6))])
def test_solve_photometric_equal(seed, kw):
    oj, ot, _ = solve_both(seed, **kw)
    assert set(ot) == set(oj)
    for k in oj:
        assert ot[k].shape == oj[k].shape and ot[k].dtype == np.float32, k
    np.testing.assert_allclose(ot["log_e"], oj["log_e"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(ot["log_L"], oj["log_L"], rtol=0, atol=5e-4)
    assert abs(float(ot["rms_after"]) - float(oj["rms_after"])) <= 1e-5
    assert abs(float(ot["rms_before"]) - float(oj["rms_before"])) <= 1e-6
    assert float(ot["n_obs"]) == float(oj["n_obs"])
    assert ot["log_e"][0] == 0.0
    hold_c(oj["c"], ot["c"])
    hold_v(oj["v"], ot["v"])


def test_correct_image_equal():
    oj, _, (obs, r2, valid, _) = solve_both(11)
    c, v = oj["c"], oj["v"]
    img = obs.astype(np.float32)
    img[0, :4] = 0.0                                 # I = 0 maps to 0
    got = T.correct_image(torch.from_numpy(img), torch.tensor(c), torch.tensor(v),
                          torch.from_numpy(r2.astype(np.float32))).numpy()
    ref = np.asarray(J.correct_image(jnp.asarray(img), jnp.asarray(c), jnp.asarray(v),
                                     jnp.asarray(r2, jnp.float32)))
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-3
    assert np.all(got[0, :4] == 0.0)
    # a whole 8-bit frame over the image plane
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 256, (48, 64)).astype(np.uint8)
    r2n = T._r2_image(48, 64, 31.5, 23.5).astype(np.float32)
    got = T.correct_image(torch.from_numpy(frame), torch.tensor(c), torch.tensor(v),
                          torch.from_numpy(r2n)).numpy()
    ref = np.asarray(J.correct_image(jnp.asarray(frame), jnp.asarray(c), jnp.asarray(v),
                                     jnp.asarray(r2n)))
    assert np.abs(got - ref).max() <= 1e-3


@pytest.mark.parametrize("seed", [5, 9])
def test_curve_and_vignette_map_equal(seed):
    oj, _, _ = solve_both(seed)
    cj = T.inverse_response_curve(oj["c"])
    ref = J.inverse_response_curve(oj["c"])
    assert cj.shape == ref.shape == (256,) and cj[0] == ref[0] == 0.0
    assert np.abs(cj - ref).max() <= 1e-3
    got = T.vignette_map(oj["v"], 48, 64, 31.5, 23.5)
    ref = J.vignette_map(oj["v"], 48, 64, 31.5, 23.5)
    assert got.shape == (48, 64)
    assert np.abs(got - ref).max() <= 1e-6
    got = T.inverse_response_curve(oj["c"], n=17)
    assert np.abs(got - J.inverse_response_curve(oj["c"], n=17)).max() <= 1e-3


def calibrator_frames(n_frames=30, seed=0):
    """``tests/test_photometric.py``'s end-to-end input: a static point set
    splatted on mid-grey under a random exposure per frame."""
    rng = np.random.default_rng(seed)
    n_pts = 60
    px = np.stack([rng.uniform(2, 61, n_pts), rng.uniform(2, 45, n_pts)], -1)
    radiance = rng.uniform(30.0, 200.0, n_pts)
    yy, xx = np.mgrid[0:48, 0:64]
    r2_img = ((xx - 31.5) ** 2 + (yy - 23.5) ** 2) / T._r2_max(64, 48, 31.5, 23.5)
    log_es = rng.uniform(-0.4, 0.4, n_frames)
    log_es[0] = 0.0
    frames = []
    for le in log_es:
        img = np.full((48, 64), 100.0)
        iu = px[:, 0].round().astype(int)
        iv = px[:, 1].round().astype(int)
        img[iv, iu] = radiance
        obs = {"valid": np.zeros(128, bool), "px": np.zeros((128, 2), np.float32),
               "point_id": np.full(128, -1, np.int32)}
        obs["valid"][:n_pts] = True
        obs["px"][:n_pts] = np.stack([iu, iv], -1)
        obs["point_id"][:n_pts] = np.arange(n_pts)
        frames.append((_forward(img, np.exp(le), r2_img), obs))
    return frames, r2_img


class Cam:
    width, height = 64, 48
    cx, cy = 31.5, 23.5


def test_calibrator_end_to_end_equal():
    frames, r2_img = calibrator_frames()
    cj = J.OnlinePhotometricCalibrator(Cam(), window=40, solve_every=10, min_frames=10)
    ct = T.OnlinePhotometricCalibrator(Cam(), window=40, solve_every=10, min_frames=10,
                                       device="cpu")
    img0 = frames[0][0]
    assert ct.correct(img0) is img0                  # identity until calibrated
    for k, (img, obs) in enumerate(frames):
        cj.add_frame_samples(img, obs)
        ct.add_frame_samples(img, obs)
        assert ct.calibrated == cj.calibrated, k
        assert len(ct.frames) == len(cj.frames)
        for key in ("pid", "inten", "r2"):
            np.testing.assert_array_equal(ct.frames[-1][key], cj.frames[-1][key])
    assert ct.calibrated
    # three solves (frames 10, 20, 30): the second and third blend 0.7 / 0.3
    hold_c(cj.c, ct.c, curve_tol=1e-3)
    hold_v(cj.v, ct.v, log_tol=1e-3)
    assert abs(ct.last_rms[1] - cj.last_rms[1]) <= 1e-5
    rms0, rms1 = ct.last_rms
    assert rms1 < 0.5 * rms0
    # the correction linearises a frame pair that differs only by exposure
    img = np.full((48, 64), 100.0)
    img[10:20, 10:30] = 180.0
    o1 = ct.correct(_forward(img, 1.0, r2_img))
    assert isinstance(o1, torch.Tensor) and o1.dtype == torch.float32
    o1 = o1.numpy()
    o2 = ct.correct(_forward(img, 1.6, r2_img)).numpy()
    m = (o1 > 20) & (o1 < 235) & (o2 > 20) & (o2 < 235)
    ratio = o2[m] / o1[m]
    assert np.std(ratio) / np.mean(ratio) < 0.05
    ref = np.asarray(cj.correct(_forward(img, 1.0, r2_img)))
    assert np.abs(o1 - ref).max() <= 0.05            # from c, v held as above


def test_calibrator_gates_and_window():
    """Too few frames or points: no solve; the window slides; frames with
    fewer than 8 samples are skipped."""
    frames, _ = calibrator_frames(n_frames=12, seed=1)
    ct = T.OnlinePhotometricCalibrator(Cam(), window=5, solve_every=100, min_frames=4,
                                       device="cpu")
    assert ct.solve() is None
    few = dict(frames[0][1])
    few["valid"] = few["valid"].copy()
    few["valid"][7:] = False
    ct.add_frame_samples(frames[0][0], few)
    assert ct.frames == []
    for img, obs in frames:
        ct.add_frame_samples(torch.from_numpy(img), obs)   # a tensor reads the same
    assert len(ct.frames) == 5
    res = ct.solve()
    cj = J.OnlinePhotometricCalibrator(Cam(), window=5, solve_every=100, min_frames=4)
    for img, obs in frames:
        cj.add_frame_samples(img, obs)
    ref = cj.solve()
    assert ct.calibrated == cj.calibrated
    np.testing.assert_allclose(res["log_e"], ref["log_e"], rtol=0, atol=1e-4)

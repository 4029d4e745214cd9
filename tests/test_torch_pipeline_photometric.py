"""The handler with online photometric calibration: the port's
``FrameHandler(cam, Config(photometric_calib=True))`` against the JAX
handler on ``tests/test_pipeline_photometric.py``'s input (the textured plane
along ``tests/test_pipeline_e2e.py``'s trajectory, through the camera's
response, vignette and a seeded exposure walk, passed as float64 images),
``solve_every`` = ``min_frames`` = 6, on the CPU.

The bootstrap ends at frame 10 and the first solve is adopted at frame 15,
so 18 frames run two corrected frames (one a keyframe event) through the
step.  Per frame: statuses, ``n_matches`` and ``n_inliers`` equal, ``T_f_w``
to 1e-4.  The calibrators: the same frames sampled, calibrated on the same
frame, the response curve Σ c_k φ_k to 1e-3 and ``v`` to 1e-3 (the
coefficients ``c`` themselves move along the normal matrix's flat direction,
``tests/test_torch_photometric.py``).
"""

import numpy as np
import pytest
import torch

from hso_tpu.cameras import PinholeCamera as JaxCamera
from hso_tpu.config import Config as JaxConfig
from hso_tpu.pipeline.frame_handler import FrameHandler as JaxHandler
from hso_tpu_torch import testing
from hso_tpu_torch.cameras import PinholeCamera
from hso_tpu_torch.config import Config
from hso_tpu_torch.pipeline.frame_handler import RESULT_FAILURE, STAGE_DEFAULT, FrameHandler
from hso_tpu_torch.pipeline.scan import pin_float32_matmul
from hso_tpu_torch.utils.synthetic import PlaneScene
from test_pipeline_e2e import make_trajectory
from test_torch_photometric import hold_c, hold_v

torch.set_num_threads(1)
pin_float32_matmul()

N_FRAMES = 18


@pytest.fixture(scope="module")
def both():
    cam = PinholeCamera(640, 480, 400.0, 400.0, 320.0, 240.0)
    scene = PlaneScene(cam, z0=2.0, extent=4.0, seed=21)
    poses = make_trajectory(36)                  # the JAX fixture's trajectory
    log_e = testing.exposure_walk(len(poses))
    r2n = testing.photo_r2n()
    hj = JaxHandler(JaxCamera(640, 480, 400.0, 400.0, 320.0, 240.0),
                    JaxConfig(photometric_calib=True))
    ht = FrameHandler(cam, Config(photometric_calib=True), device="cpu")
    for h in (hj, ht):
        h.photo.solve_every = 6
        h.photo.min_frames = 6
    recs = []
    for k in range(N_FRAMES):
        img = testing.photo_distort(scene.render(poses[k]).astype(np.float64), log_e[k], r2n)
        calibrated_before = ht.photo.calibrated
        rj, rt = hj.add_image(img, ts=float(k)), ht.add_image(img, ts=float(k))
        recs.append(dict(j=rj, t=rt, corrected=calibrated_before,
                         calibrated=(hj.photo.calibrated, ht.photo.calibrated),
                         frames=(len(hj.photo.frames), len(ht.photo.frames))))
    return recs, hj, ht


def test_statuses_and_counts_equal(both):
    recs, hj, ht = both
    for k, r in enumerate(recs):
        assert r["t"].status == r["j"].status, (k, r["t"].status, r["j"].status)
        assert r["t"].n_matches == r["j"].n_matches, k
        assert r["t"].n_inliers == r["j"].n_inliers, k
        assert r["calibrated"][0] == r["calibrated"][1], k
        assert r["frames"][0] == r["frames"][1], k
    assert ht.stage == hj.stage == STAGE_DEFAULT
    assert not any(r["t"].status == RESULT_FAILURE for r in recs)
    assert sum(r["corrected"] for r in recs) >= 2       # the step ran on corrected frames


def test_poses_equal(both):
    recs, _, _ = both
    for k, r in enumerate(recs):
        np.testing.assert_allclose(r["t"].T_f_w, r["j"].T_f_w, rtol=0, atol=1e-4,
                                   err_msg=str(k))


def test_calibrators_equal(both):
    _, hj, ht = both
    assert ht.photo.calibrated and hj.photo.calibrated
    hold_c(hj.photo.c, ht.photo.c, curve_tol=1e-3)
    hold_v(hj.photo.v, ht.photo.v, log_tol=1e-3)
    assert abs(ht.photo.last_rms[1] - hj.photo.last_rms[1]) <= 1e-5
    assert ht.photo.last_rms[1] < ht.photo.last_rms[0]
    # the same points sampled; with poses 1e-4 apart the matched positions
    # agree to ~2e-2 px, so the raw intensities under them to 1 grey level on
    # gradients up to ~50 a pixel, and to 0.05 on average
    for fj, ft in zip(hj.photo.frames, ht.photo.frames):
        np.testing.assert_array_equal(ft["pid"], fj["pid"])
        d = np.abs(ft["inten"] - fj["inten"])
        assert d.max() <= 1.0 and d.mean() <= 0.05, (d.max(), d.mean())


def test_solve_on_the_pipelines_samples_agrees_modulo_the_gamma_ambiguity(both):
    """The calibrator's window (the pipeline's own samples) solved by JAX, by
    the port, and by the port with the points in another order (another order
    of every sum): the fits agree (``rms_after`` to 1e-5) and the exposures
    agree to 1e-4 once one common factor α is taken out (|α - 1| ≤ 5e-3):
    float32 rounding moves a solve along the gamma ambiguity U^α, e^α, V^α.
    ``chip_smoke.py`` holds the card against the CPU the same way."""
    import jax.numpy as jnp

    from hso_tpu.photometric.online_calib import solve_photometric as jax_solve
    from hso_tpu_torch.photometric.online_calib import solve_photometric

    _, _, ht = both
    inten, r2, valid = ht.photo.problem()
    perm = np.random.default_rng(0).permutation(inten.shape[1])
    runs = {
        "jax": {k: np.asarray(v) for k, v in jax_solve(
            jnp.asarray(inten), jnp.asarray(r2), jnp.asarray(valid)).items()},
        "port": {k: v.numpy() for k, v in solve_photometric(
            torch.from_numpy(inten), torch.from_numpy(r2), torch.from_numpy(valid)).items()},
        "port, points permuted": {k: v.numpy() for k, v in solve_photometric(
            torch.from_numpy(inten[:, perm]), torch.from_numpy(r2[:, perm]),
            torch.from_numpy(valid[:, perm])).items()},
    }
    ref = runs["port"]
    for name, out in runs.items():
        assert abs(float(out["rms_after"]) - float(ref["rms_after"])) <= 1e-5, name
        alpha, mod_alpha = testing.exposure_gauge(out["log_e"], ref["log_e"])
        assert abs(alpha - 1.0) <= 5e-3 and mod_alpha <= 1e-4, (name, alpha, mod_alpha)


def test_reset_keeps_the_schedule(both):
    _, _, ht = both
    h = FrameHandler(ht.cam, Config(photometric_calib=True), device="cpu")
    h.photo.solve_every, h.photo.min_frames = 6, 5
    h.photo.calibrated = True
    h.reset_all()
    assert not h.photo.calibrated and h.photo.frames == []
    assert (h.photo.solve_every, h.photo.min_frames) == (6, 5)

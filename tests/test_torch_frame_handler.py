"""The host pipeline: the port's ``FrameHandler.add_image`` against the JAX
package's on the CPU.

(a) The bootstrap on ``tests/test_pipeline_e2e.py``'s trajectory (textured
    plane, 640×480) from frame 0 up to the keyframe forced after the
    initialisation, plus three frames: per-frame statuses equal, point counts
    equal, ``T_f_w`` to 1e-5.
(b) The resume from ``artifacts/bench_boot.npz`` with
    ``resume_stage="default"`` through the first keyframe event the handler
    decides, plus one frame: statuses and keyframe decisions equal, ``T_f_w``
    to 1e-5, point and seed counts within ±2.  The counter repair (a reused
    point row starts at n_succ = n_fail = 0 in the port) cannot show here:
    no row is released and handed out again before the event; the test
    checks that, so a divergence from the repair would be named.

Both handlers see the same rendered images.  The JAX side runs its Pallas
kernels' plain references on the CPU, as its own tests do.
"""

import numpy as np
import pytest
import torch

from hso_tpu.cameras import PinholeCamera as JaxCamera
from hso_tpu.config import Config as JaxConfig
from hso_tpu.pipeline.frame_handler import FrameHandler as JaxHandler
from hso_tpu.utils.checkpoint import load_checkpoint as jax_load
from hso_tpu_torch.bench import BOOT_NPZ, bench_camera, bench_scene, trajectory
from hso_tpu_torch.cameras import PinholeCamera
from hso_tpu_torch.config import Config
from hso_tpu_torch.pipeline.frame_handler import (RESULT_KEYFRAME, STAGE_DEFAULT,
                                                  FrameHandler)
from hso_tpu_torch.utils.checkpoint import load_checkpoint
from hso_tpu_torch.utils.synthetic import PlaneScene
from test_pipeline_e2e import make_trajectory

torch.set_num_threads(1)


def jax_handler():
    return JaxHandler(JaxCamera(640, 480, 400.0, 400.0, 320.0, 240.0), JaxConfig())


def step_both(hj, ht, img, ts):
    rj, rt = hj.add_image(img, ts=ts), ht.add_image(img, ts=ts)
    return dict(status=(rj.status, rt.status), stage=(hj.stage, ht.stage),
                T=(rj.T_f_w, rt.T_f_w), inliers=(rj.n_inliers, rt.n_inliers),
                points=(int(hj.points.valid.sum()), int(ht.points.valid.sum())),
                seeds=(int(np.asarray(hj.seeds["valid"]).sum()), int(ht.seeds["valid"].sum())))


@pytest.fixture(scope="module")
def bootstrap():
    cam = PinholeCamera(640, 480, 400.0, 400.0, 320.0, 240.0)
    scene = PlaneScene(cam, z0=2.0, extent=4.0, seed=21)
    hj, ht = jax_handler(), FrameHandler(cam, Config(), device="cpu")
    recs, after = [], None
    for k, T in enumerate(make_trajectory(36)):
        recs.append(step_both(hj, ht, scene.render(T), float(k)))
        if after is None and recs[-1]["stage"][1] == STAGE_DEFAULT and len(ht.kfs.frames) == 3:
            after = k                    # the keyframe forced after the bootstrap
        if after is not None and k == after + 3:
            break
    assert after is not None, [r["status"] for r in recs]
    return recs, hj, ht


def test_bootstrap_statuses_and_points(bootstrap):
    recs, hj, ht = bootstrap
    for k, r in enumerate(recs):
        assert r["status"][0] == r["status"][1], (k, r["status"])
        assert r["stage"][0] == r["stage"][1], (k, r["stage"])
        assert r["points"][0] == r["points"][1], (k, r["points"])
        assert r["inliers"][0] == r["inliers"][1], (k, r["inliers"])
    assert ht.stage == STAGE_DEFAULT and len(ht.kfs.frames) == len(hj.kfs.frames) == 3
    assert recs[-1]["points"][1] > 100


def test_bootstrap_poses(bootstrap):
    recs, hj, ht = bootstrap
    for k, r in enumerate(recs):
        np.testing.assert_allclose(r["T"][1], r["T"][0], rtol=0, atol=1e-5, err_msg=str(k))
    # the two-view geometry and the bootstrap map: the same bits
    np.testing.assert_array_equal(ht.kfs.poses[:2], hj.kfs.poses[:2])
    np.testing.assert_array_equal(ht.points.host_win, hj.points.host_win)
    np.testing.assert_array_equal(ht.points.host_f, hj.points.host_f)


@pytest.fixture(scope="module")
def resumed():
    hj, ht = jax_handler(), FrameHandler(bench_camera(), Config(), device="cpu")
    jax_load(hj, BOOT_NPZ, resume_stage="default")
    load_checkpoint(ht, BOOT_NPZ, resume_stage="default")
    start = ht.frame_count
    scene = bench_scene(bench_camera())
    recs, event = [], None
    for k, T in enumerate(trajectory(start + 12)[start:]):
        recs.append(step_both(hj, ht, scene.render(T), float(start + k)))
        if event is None and recs[-1]["status"][1] == RESULT_KEYFRAME:
            event = k
        if event is not None and k == event + 1:
            break
    assert event is not None, [r["status"] for r in recs]
    return recs, hj, ht


def test_resume_through_the_first_decided_event(resumed):
    recs, hj, ht = resumed
    for k, r in enumerate(recs):
        assert r["status"][0] == r["status"][1], (k, r["status"])
        np.testing.assert_allclose(r["T"][1], r["T"][0], rtol=0, atol=1e-5, err_msg=str(k))
        assert abs(r["points"][0] - r["points"][1]) <= 2, (k, r["points"])
        assert abs(r["seeds"][0] - r["seeds"][1]) <= 2, (k, r["seeds"])
    assert [r["status"][1] for r in recs].count(RESULT_KEYFRAME) == 1
    assert len(ht.kfs.frames) == len(hj.kfs.frames) == 7


def test_no_reused_row_before_the_event(resumed):
    """The counter repair changes nothing on this segment: every row the point
    tables hold is where the JAX table has it, with the same counts."""
    _, hj, ht = resumed
    np.testing.assert_array_equal(ht.points.valid, hj.points.valid)
    np.testing.assert_array_equal(ht.points.type, hj.points.type)
    np.testing.assert_array_equal(ht.points.n_succ, hj.points.n_succ)
    np.testing.assert_array_equal(ht.points.n_fail, hj.points.n_fail)

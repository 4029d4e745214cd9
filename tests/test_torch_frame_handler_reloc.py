"""The port's relocalization and reset, alone, under the assertions of
``tests/test_reloc.py``: the closest same-facing keyframe with a pyramid is
chosen; after a blackout the handler recovers into DEFAULT within three
frames near the true position; prolonged failure ends in ``reset_all`` and a
new bootstrap.  The tracked segment is the first 48 of that file's 60 frames
(three keyframes and more, as it asks), to keep this file within its time on
the CPU.  (The handler against the JAX package is
``tests/test_torch_frame_handler.py``.)"""

import numpy as np
import pytest
import torch

from hso_tpu_torch.cameras import PinholeCamera
from hso_tpu_torch.mapmodel.structures import Frame, empty_obs
from hso_tpu_torch.math import se3np
from hso_tpu_torch.pipeline.frame_handler import (RESULT_FAILURE, STAGE_DEFAULT, STAGE_FIRST,
                                                  STAGE_RELOC, FrameHandler)
from hso_tpu_torch.utils.synthetic import PlaneScene

torch.set_num_threads(1)


def _cam():
    return PinholeCamera(640, 480, 400.0, 400.0, 320.0, 240.0)


def _pose(x, y=0.0, z=0.0):
    return se3np.exp(np.r_[x, y, z, 0.0, 0.0, 0.0])


def test_closest_keyframe_is_distance_ranked():
    vo = FrameHandler(_cam(), device="cpu")
    fake_pyr = {"pyr": (torch.zeros((480, 640)),)}
    for i, x in enumerate((0.0, 0.5, 1.0, 1.5)):
        vo.kfs.add(Frame(frame_id=i, timestamp=float(i), T_f_w=_pose(x), data=dict(fake_pyr),
                         obs=empty_obs(8)))
    assert vo._closest_keyframe(_pose(0.4)) is vo.kfs.frames[1]
    vo.kfs.frames[1].T_f_w = se3np.mul(se3np.exp(np.r_[0.0, 0, 0, 0.0, np.pi, 0.0]),
                                       _pose(0.5))
    assert vo._closest_keyframe(_pose(0.4)) is not vo.kfs.frames[1]
    for f in vo.kfs.frames:
        f.data = None
    assert vo._closest_keyframe(_pose(0.4)) is None


@pytest.fixture(scope="module")
def tracked_vo():
    cam = _cam()
    scene = PlaneScene(cam, z0=2.5, extent=4.0, seed=7)
    vo = FrameHandler(cam, device="cpu")
    poses = []
    for k in range(48):
        t = k / 12.0
        poses.append(_pose(0.9 * np.sin(0.7 * t), 0.05 * t, 0.04 * t))
    for k, T in enumerate(poses):
        vo.add_image(scene.render(T), ts=float(k))
    assert vo.stage == STAGE_DEFAULT, vo.stage
    assert len(vo.kfs.frames) >= 3
    return dict(vo=vo, scene=scene, poses=poses, cam=cam)


def test_blackout_recovery(tracked_vo):
    vo, scene = tracked_vo["vo"], tracked_vo["scene"]
    T_resume = tracked_vo["poses"][-1]
    black = np.zeros((480, 640), np.uint8)
    for k in range(3):
        vo.add_image(black, ts=100.0 + k)
    assert vo.stage == STAGE_RELOC
    recovered = False
    for k in range(3):
        res = vo.add_image(scene.render(T_resume), ts=110.0 + k)
        if res.status != RESULT_FAILURE and vo.stage == STAGE_DEFAULT:
            recovered = True
            break
    assert recovered
    t_est = se3np.translation(se3np.inv(vo.last_frame.T_f_w))
    t_gt = se3np.translation(se3np.inv(T_resume))
    assert np.linalg.norm(t_est - t_gt) < 0.35, (t_est, t_gt)


def test_starvation_triggers_reset(tracked_vo):
    vo = tracked_vo["vo"]
    black = np.zeros((480, 640), np.uint8)
    for k in range(3):
        vo.add_image(black, ts=200.0 + k)
    assert vo.stage == STAGE_RELOC
    for k in range(vo.RELOC_MAX_FAILURES + 2):
        vo.add_image(black, ts=210.0 + k)
        if vo.stage == STAGE_FIRST:
            break
    assert vo.stage == STAGE_FIRST
    assert len(vo.kfs.frames) == 0
    assert int(vo.points.valid.sum()) == 0
    assert not bool(vo.seeds["valid"].any()) and vo._acc is None
    vo.add_image(tracked_vo["scene"].render(_pose(0.0)), ts=300.0)
    assert vo.stage != STAGE_RELOC


def test_reused_row_counters_restart_on_the_device_too():
    """Between two drains a released row can hold device counts: one step
    counts its matches into ``acc``, then the relocalization path's
    ``_reproject`` releases a point without a drain.  When the seed rescue
    hands that row out again, its device counters restart at 0 with the host
    ones; else the next drain would give the new point the old one's counts."""
    from hso_tpu_torch.bench import BOOT_NPZ, bench_camera, bench_scene, trajectory
    from hso_tpu_torch.utils.checkpoint import load_checkpoint

    cam = bench_camera()
    vo = FrameHandler(cam, device="cpu")
    load_checkpoint(vo, BOOT_NPZ, resume_stage="default")
    vo.add_image(bench_scene(cam).render(trajectory(vo.frame_count + 1)[-1]), ts=0.0)
    acc = vo._acc.numpy()
    counted = np.nonzero(acc[1] > 0)[0]              # rows with failed matches
    assert len(counted) > 0
    row = int(counted[0])
    vo.points.release([row])                         # no drain: acc keeps the counts
    assert vo._acc[1, row] > 0 and not vo.points.valid[row]
    free = list(vo.points._free)
    vo.points._free = [i for i in free if i != row] + [row]     # the next row handed out
    (again,) = vo._alloc_between_drains(1)
    assert again == row
    assert vo.points.n_succ[row] == vo.points.n_fail[row] == 0
    assert int(vo._acc[0, row]) == int(vo._acc[1, row]) == 0
    others = np.arange(acc.shape[1]) != row
    np.testing.assert_array_equal(vo._acc.numpy()[:, others], acc[:, others])

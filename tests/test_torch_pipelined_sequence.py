"""The lag-1 host loop on a whole sequence: the port's counterparts of the
two cases of ``tests/test_pipeline_pipelined.py``, on the CPU.

The plane scene of ``tests/test_pipeline_e2e.py`` (640×480, 30 frames from
frame 0): the lag-1 loop hands the bootstrap frames to ``add_image`` and
tracks the rest with keyframe updates one frame late.  It must return one
result per frame, in order, with no failure, and track the ground truth as
well as the synchronous loop does: the scale-aligned ATE of the last 20
frames below max(2.5 × the synchronous loop's, 0.05 m), the JAX test's bound.
Entered mid-stream (16 frames through ``add_image``, then the lag-1 loop, as
the bench does) it returns one result per remaining frame, in order.
"""

import numpy as np
import pytest
import torch

from hso_tpu_torch.cameras import PinholeCamera
from hso_tpu_torch.config import Config
from hso_tpu_torch.math import se3np
from hso_tpu_torch.pipeline.frame_handler import RESULT_FAILURE, STAGE_DEFAULT, FrameHandler
from hso_tpu_torch.utils.synthetic import PlaneScene
from test_pipeline_e2e import make_trajectory

torch.set_num_threads(1)
N_FRAMES = 30
SPLIT = 16


@pytest.fixture(scope="module")
def scene_and_frames():
    cam = PinholeCamera(640, 480, 400.0, 400.0, 320.0, 240.0)
    scene = PlaneScene(cam, z0=2.0, extent=4.0, seed=21)
    poses = make_trajectory(N_FRAMES)
    return cam, poses, [scene.render(T) for T in poses]


def _centers(traj):
    return {int(ts): se3np.translation(se3np.inv(T)) for ts, T in traj}


def _pipelined(vo, frames, first):
    res = []
    for k, img in enumerate(frames):
        r = vo.add_image_pipelined(img, ts=float(first + k))
        if r is not None:
            res.append(r)
    return res + vo.flush()


def test_pipelined_tracks_as_the_synchronous_loop(scene_and_frames):
    cam, poses, frames = scene_and_frames
    vo_s = FrameHandler(cam, Config(), device="cpu")
    for k, img in enumerate(frames):
        vo_s.add_image(img, ts=float(k))
    vo_p = FrameHandler(cam, Config(), device="cpu")
    results = _pipelined(vo_p, frames, 0)

    assert len(results) == len(frames)
    assert vo_p.stage == STAGE_DEFAULT
    assert not any(r.status == RESULT_FAILURE for r in results)
    assert len(vo_p.kfs.frames) >= 3
    ts_seen = [int(ts) for ts, _ in vo_p.trajectory]
    assert ts_seen == list(range(len(frames)))

    cs, cp = _centers(vo_s.trajectory), _centers(vo_p.trajectory)
    gt = {k: se3np.translation(se3np.inv(T)) for k, T in enumerate(poses)}
    common = sorted(set(cs) & set(cp))[-20:]

    def ate(est):
        e = np.stack([est[k] for k in common])
        g = np.stack([gt[k] for k in common])
        e, g = e - e.mean(0), g - g.mean(0)
        s = np.sum(e * g) / max(np.sum(e * e), 1e-12)
        return float(np.sqrt(np.mean(np.sum((s * e - g) ** 2, -1))))

    a_s, a_p = ate(cs), ate(cp)
    assert a_p < max(2.5 * a_s, 0.05), (a_p, a_s)


def test_pipelined_entered_midstream(scene_and_frames):
    cam, _, frames = scene_and_frames
    vo = FrameHandler(cam, Config(), device="cpu")
    for k in range(SPLIT):
        vo.add_image(frames[k], ts=float(k))
    assert vo.stage == STAGE_DEFAULT
    res = _pipelined(vo, frames[SPLIT:], SPLIT)
    assert len(res) == len(frames) - SPLIT
    assert not any(x.status == RESULT_FAILURE for x in res)
    ts_seen = [int(ts) for ts, _ in vo.trajectory]
    assert ts_seen == list(range(len(frames)))


def test_pipelined_refuses_photometric_calibration(scene_and_frames):
    """As in the JAX loop: the calibrator samples every frame synchronously."""
    cam, _, frames = scene_and_frames
    vo = FrameHandler(cam, Config(photometric_calib=True), device="cpu")
    with pytest.raises(ValueError, match="photometric_calib"):
        vo.add_image_pipelined(frames[0])


def test_calibrator_lives_on_the_handlers_device(scene_and_frames):
    """``OnlinePhotometricCalibrator`` defaults to the card; the handler passes
    its own device, so its calibrator's tensors live there."""
    import inspect

    from hso_tpu_torch.photometric import OnlinePhotometricCalibrator

    assert inspect.signature(OnlinePhotometricCalibrator).parameters["device"].default == "cuda"
    cam, _, _ = scene_and_frames
    vo = FrameHandler(cam, Config(photometric_calib=True), device="cpu")
    assert vo.photo.device == torch.device("cpu") and vo.photo._r2_img.device.type == "cpu"
    vo.reset_all()
    assert vo.photo.device == torch.device("cpu")

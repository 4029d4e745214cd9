"""The dataset cameras on the port's path, against the JAX package (CPU).

K3 projects through the camera's model: the coarse tracker takes the fused IC
level (K3, here its plain version) for every camera whose projection
``projection_model`` names, and the JAX tracker runs that level through
``cam.world2cam``.  Held here:

(a) ``projection_model`` for the four calibrations of ``data/cameras`` and the
    cameras the runner hands the handler, and K3's projection against
    ``cam.world2cam`` for each model;
(b) the IC tracker (three levels) and one IC level, port against JAX, on the
    problem of ``tests/test_torch_coarse.py`` rendered through a
    radial-tangential camera (EuRoC's coefficients), an unrectified FOV camera
    and the ideal pinhole of ``ideal()``, at that file's tolerances: pose
    1e-3 (|log| of the relative transform), the same ``n_tracked``, energy
    within 5 %, exposure ratio 1e-3;
(c) ``FrameHandler.add_image`` with an unrectified FOV camera at 640×480 from
    frame 0 through the bootstrap and three frames, against the JAX handler:
    statuses, stages and points equal, ``T_f_w`` to 1e-5 (the tolerance of
    ``tests/test_torch_frame_handler.py``);
(d) the runner's whole-image rectification (``run_dataset.Undistorter``) on
    the wide TUM MonoVO calibration and on EuRoC's with rectification asked
    for, against the JAX runner's ``remap_bilinear``: the same remap tables,
    the resampled float image to 1e-3 and the same uint8 pixels but where
    the two float32 sums straddle a whole grey level.
"""

import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hso_tpu.cameras import FOVCamera as JaxFOV
from hso_tpu.cameras import PinholeCamera as JaxPinhole
from hso_tpu.config import Config as JaxConfig
from hso_tpu.image.pyramid import build_frame_pyramids as jax_pyramids
from hso_tpu.image.pyramid import remap_bilinear as jax_remap
from hso_tpu.io.calib import parse_calib as jax_parse_calib
from hso_tpu.pipeline.frame_handler import FrameHandler as JaxHandler
from hso_tpu.track.coarse_tracker import make_coarse_tracker as jax_make_tracker
from hso_tpu_torch import testing
from hso_tpu_torch.cameras import (AbstractCamera, EquidistantCamera, FOVCamera,
                                   PinholeCamera, projection_model)
from hso_tpu_torch.config import Config
from hso_tpu_torch.image.pyramid import build_frame_pyramids, remap_bilinear
from hso_tpu_torch.io.calib import parse_calib
from hso_tpu_torch.math import se3np
from hso_tpu_torch.pipeline.frame_handler import STAGE_DEFAULT, FrameHandler
from hso_tpu_torch.run_dataset import Undistorter, make_handler
from hso_tpu_torch.track import coarse_cuda
from hso_tpu_torch.track.coarse_tracker import make_coarse_tracker
from hso_tpu_torch.utils.synthetic import PlaneScene
from test_pipeline_e2e import make_trajectory

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMERAS = os.path.join(ROOT, "data", "cameras")
T_GT = se3np.exp(np.array([0.03, -0.02, 0.015, 0.006, -0.008, 0.004]))
N_MAX = 96
#: EuRoC's radial-tangential coefficients (data/cameras/euroc.txt), rounded
RADTAN = (-0.2834, 0.0740, 1.9e-4, 1.8e-5)
K = (320, 240, 200.0, 200.0, 160.0, 120.0)


def cameras(kind):
    """(port camera, JAX camera) of one kind at the coarse problem's size."""
    if kind == "radtan":
        return PinholeCamera(*K, *RADTAN), JaxPinhole(*K, *RADTAN)
    if kind == "fov":
        return FOVCamera(*K, 0.9), JaxFOV(*K, 0.9)
    return FOVCamera(*K, 0.9).ideal(), JaxFOV(*K, 0.9).ideal()


def _se3_dist(Ta, Tb):
    return np.linalg.norm(se3np.log(se3np.mul(np.asarray(Ta, np.float64),
                                              se3np.inv(np.asarray(Tb, np.float64)))))


# ---------------------------------------------------------------- (a)
@pytest.mark.parametrize("name,model", [("euroc", "radtan"), ("icl-nuim", "ideal"),
                                        ("tum_mono_vo_narrow", "fov"),
                                        ("tum_mono_vo_wide", "ideal")])
def test_projection_model_of_the_calibrations(name, model):
    cam = parse_calib(os.path.join(CAMERAS, f"{name}.txt"))
    got = projection_model(cam)
    assert got[0] == model
    if model == "radtan":
        assert got[1] == cam.d and len(got[1]) == 5
    if model == "fov":
        assert got[1] == (cam.omega, 2.0 * math.tan(cam.omega / 2.0))
    # what the runner hands the handler projects ideal where it rectifies
    vo, undistort = make_handler(cam, torch.device("cpu"))
    assert (undistort is not None) == (name == "tum_mono_vo_wide")
    assert projection_model(vo.cam)[0] == ("ideal" if undistort is not None else model)


def test_projection_model_reads_the_camera_not_its_class():
    assert projection_model(PinholeCamera(*K)) == ("ideal", ())
    assert projection_model(PinholeCamera(*K).ideal()) == ("ideal", ())
    assert projection_model(FOVCamera(*K, 0.9, undistort_image=True)) == ("ideal", ())
    assert projection_model(EquidistantCamera(*K, 0.1, 0.01, 0.0, 0.0)) == ("ideal", ())
    assert projection_model(AbstractCamera(*K)) == ("ideal", ())
    # d0 alone decides whether the pinhole distorts, as in its `distort`
    assert projection_model(PinholeCamera(*K, 0.0, 0.1))[0] == "ideal"

    class Warped(AbstractCamera):
        def distort(self, x, y):
            return 1.1 * x, y

    class OwnProjection(PinholeCamera):
        def world2cam(self, xyz):
            return super().world2cam(xyz)

    assert projection_model(Warped(*K)) is None
    assert projection_model(OwnProjection(*K, *RADTAN)) is None


@pytest.mark.parametrize("kind", ["radtan", "fov", "ideal"])
@pytest.mark.parametrize("level", [0, 2])
def test_level_projection_is_the_cameras(kind, level):
    """K3's projection (the plain version's ``project_level``) against
    ``cam.world2cam`` scaled to the level, on points across the image."""
    cam, _ = cameras(kind)
    rng = np.random.default_rng(5)
    px = np.stack([rng.uniform(0, 320, 500), rng.uniform(0, 240, 500)], -1)
    xyz = torch.as_tensor(cam.cam2world(px) * rng.uniform(0.5, 4.0, (500, 1)),
                          dtype=torch.float32)
    s = 1.0 / (1 << level)
    u, v = coarse_cuda.project_level(xyz, cam.fx * s, cam.fy * s, cam.cx * s, cam.cy * s,
                                     projection_model(cam))
    want = cam.world2cam(xyz) * s
    np.testing.assert_allclose(u.numpy(), want[:, 0].numpy(), atol=2e-4)
    np.testing.assert_allclose(v.numpy(), want[:, 1].numpy(), atol=2e-4)
    np.testing.assert_allclose(cam.world2cam(xyz.numpy().astype(np.float64)), px, atol=1e-3)


# ---------------------------------------------------------------- (b)
@pytest.fixture(scope="module", params=["radtan", "fov", "ideal"])
def problem(request):
    cam, cam_j = cameras(request.param)
    scene = PlaneScene(cam, z0=2.0, extent=2.5, seed=3, tex_size=1024)
    ref_img = scene.render()
    cur_img = scene.render(T_GT, exposure=0.97)
    px, f, dist = scene.grid_features(step=28, border=28)
    px_p, f_p, d_p = testing.pad_features(px, f, dist, N_MAX)
    return dict(kind=request.param, cam=cam, cam_j=cam_j, px=px_p, f=f_p, dist=d_p,
                ref=build_frame_pyramids(ref_img, device="cpu")["pyr"],
                cur=build_frame_pyramids(cur_img, device="cpu")["pyr"],
                ref_j=jax_pyramids(jnp.asarray(ref_img))["pyr"],
                cur_j=jax_pyramids(jnp.asarray(cur_img))["pyr"])


def _track_both(p, **kw):
    T0 = se3np.identity().astype(np.float32)
    ref = jax.tree.map(np.asarray, jax_make_tracker(p["cam_j"], inverse=True, **kw)(
        p["ref_j"], p["cur_j"], p["px"], p["f"], p["dist"], T0, 1.0))
    before = dict(coarse_cuda.LAUNCHES)
    calls = []
    plain = coarse_cuda.coarse_level_ic_plain

    def recorded(*a, **k):
        calls.append(k["projection"])
        return plain(*a, **k)

    coarse_cuda.coarse_level_ic_plain = recorded
    try:
        out = make_coarse_tracker(p["cam"], inverse=True, device="cpu", **kw)(
            p["ref"], p["cur"], p["px"], p["f"], p["dist"], T0, 1.0)
    finally:
        coarse_cuda.coarse_level_ic_plain = plain
    assert coarse_cuda.LAUNCHES == before          # CPU tensors: the plain version
    # every level went through K3's plain version with the camera's model
    assert calls == [projection_model(p["cam"])] * len(out["n_iters"])
    return ref, out


def _hold(ref, out):
    assert _se3_dist(out["T_cur_ref"].numpy(), ref["T_cur_ref"]) < 1e-3
    assert abs(float(out["exposure_ratio"]) - float(ref["exposure_ratio"])) < 1e-3
    assert int(out["n_tracked"]) == int(ref["n_tracked"])
    np.testing.assert_allclose(float(out["energy"]), float(ref["energy"]), rtol=0.05)


def test_ic_tracker_matches_jax(problem):
    ref, out = _track_both(problem, max_level=3)
    _hold(ref, out)
    # both solve the problem (to a few 1e-3, as with the ideal pinhole)
    for r in (ref["T_cur_ref"], out["T_cur_ref"].numpy()):
        assert _se3_dist(r, T_GT) < 1.5e-2
    assert int(out["n_tracked"]) >= 60


@pytest.mark.parametrize("level,offset", [(2, 2), (1, 5)], ids=["level2-P9-top", "level1-P21"])
def test_one_ic_level_matches_jax(problem, level, offset):
    """One level alone (the tracker cut to ``max_level = min_level``), with the
    top level's energy at P = 9 and with the finest pattern, P = 21."""
    ref, out = _track_both(problem, max_level=level, min_level=level, pattern_offset=offset)
    assert out["n_iters"].shape == (1,)
    _hold(ref, out)


# ---------------------------------------------------------------- (c)
FOV_640 = (640, 480, 0.535719308086809, 0.669566858850269, 0.493248545285398,
           0.500408664348414, 0.897966326944875)


def test_handler_bootstrap_with_an_unrectified_fov_camera():
    """TUM MonoVO narrow's FOV model at 640×480 (normalised intrinsics scale
    with the image), frame 0 through the bootstrap and three frames."""
    cam, cam_j = FOVCamera(*FOV_640), JaxFOV(*FOV_640)
    assert projection_model(cam)[0] == "fov"
    scene = PlaneScene(cam, z0=2.0, extent=4.0, seed=21)
    hj, ht = JaxHandler(cam_j, JaxConfig()), FrameHandler(cam, Config(), device="cpu")
    after, k = None, 0
    for k, T in enumerate(make_trajectory(36)):
        img = scene.render(T)
        rj, rt = hj.add_image(img, ts=float(k)), ht.add_image(img, ts=float(k))
        assert rj.status == rt.status and hj.stage == ht.stage, (k, rj.status, rt.status)
        assert rj.n_inliers == rt.n_inliers, k
        assert int(hj.points.valid.sum()) == int(ht.points.valid.sum()), k
        np.testing.assert_allclose(rt.T_f_w, rj.T_f_w, rtol=0, atol=1e-5, err_msg=str(k))
        if after is None and ht.stage == STAGE_DEFAULT and len(ht.kfs.frames) == 3:
            after = k
        if after is not None and k == after + 3:
            break
    assert after is not None and k == after + 3
    assert int(ht.points.valid.sum()) > 100


# ---------------------------------------------------------------- (d)
@pytest.mark.parametrize("name", ["tum_mono_vo_wide", "euroc-rectified"])
def test_rectification_matches_the_jax_remap(name, tmp_path):
    src = os.path.join(CAMERAS, f"{name.split('-')[0]}.txt")
    if name.endswith("rectified"):
        with open(src) as fh:
            lines = fh.read().splitlines()
        src = str(tmp_path / "calib.txt")
        with open(src, "w") as fh:
            fh.write("\n".join(lines[:2] + ["true"]) + "\n")
    cam, cam_j = parse_calib(src), jax_parse_calib(src)
    assert cam.undistort_image and (cam.width, cam.height) == (cam_j.width, cam_j.height)
    img = np.random.default_rng(2).integers(0, 256, (cam.height, cam.width)).astype(np.uint8)
    und = Undistorter(cam, torch.device("cpu"))
    got = und(img)
    assert got.dtype == torch.uint8 and tuple(got.shape) == img.shape
    mx, my = cam_j.undistort_remap()
    np.testing.assert_array_equal(und.map_x.numpy(), mx)
    np.testing.assert_array_equal(und.map_y.numpy(), my)
    want_f = np.asarray(jax_remap(jnp.asarray(img), jnp.asarray(mx), jnp.asarray(my)))
    got_f = remap_bilinear(torch.from_numpy(img), und.map_x, und.map_y).numpy()
    np.testing.assert_allclose(got_f, want_f, rtol=0, atol=1e-3)
    # truncated to uint8: the same pixels, but where the two float32 sums lie
    # on either side of a whole grey level (within their 1e-3)
    edge = np.abs(want_f - np.round(want_f)) <= 1e-3
    np.testing.assert_array_equal(got.numpy()[~edge], want_f.astype(np.uint8)[~edge])
    assert np.abs(got.numpy().astype(int) - want_f.astype(np.uint8))[edge].max(initial=0) <= 1
    moved = float(np.abs(mx - np.arange(cam.width)[None, :]).max())
    # the wide calibration's FOV camera reports no distortion once rectification
    # is asked for, so its remap is the identity (ROADMAP §3); EuRoC's is not
    assert (moved == 0.0) == (name == "tum_mono_vo_wide")

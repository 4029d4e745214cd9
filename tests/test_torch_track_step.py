"""The slice as a whole: ``make_track_step`` against JAX ``make_frame_step``
on the CPU.

A two-view ``PlaneScene`` with ground-truth depths, a hand-built point table
whose windows come from JAX ``memoize_level_windows``; the same numpy arrays
go into the JAX step (with ``empty_seeds(16)``, so the real fused step is the
reference) and into the port via ``snapshot_from_numpy``.

Tolerances, and why: both sides are float32 and sum in different orders
through up to 30 accept/reject LM steps per coarse level, 10 alignment steps
per candidate and up to 60 pose trials, so poses are held to 1e-3 (|log| of
the relative transform), the exposure to 1e-3, matched pixels to 1e-2 on
cells both call successful, and the success / inlier masks to agreement on
≥ 95 % of cells (a candidate at a gate may fall either way).  Cell and
candidate selection is integer work and must agree exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hso_tpu.cameras import PinholeCamera as JaxPinhole
from hso_tpu.image.pyramid import build_frame_pyramids as jax_pyramids
from hso_tpu.mapping.depth_filter import empty_seeds
from hso_tpu.ops.warp import memoize_level_windows
from hso_tpu.pipeline.fused_step import make_frame_step
from hso_tpu_torch import testing
from hso_tpu_torch.cameras import PinholeCamera
from hso_tpu_torch.image.pyramid import build_frame_pyramids
from hso_tpu_torch.math import se3np
from hso_tpu_torch.pipeline.fused_step import PT_COLS, make_track_step, pack_light
from hso_tpu_torch.utils.checkpoint import prev_obs_from_numpy, snapshot_from_numpy
from hso_tpu_torch.utils.synthetic import PlaneScene

torch.set_num_threads(1)

P_MAX = 512
GRID = (20, 12, 16)
C = GRID[1] * GRID[2]
STEP_ARGS = (GRID, 3, 0, 30, 2, 2.0)      # klt 3..1, 30 LM iterations, pattern 2, 2 px
T_CUR = se3np.exp(np.array([0.03, -0.02, 0.015, 0.006, -0.008, 0.004]))
SEED_KEYS = ("seeds", "n_seeds_updated", "seed_match_px", "seed_matched", "kf_pack")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _se3_dist(Ta, Tb):
    return np.linalg.norm(se3np.log(se3np.mul(np.asarray(Ta, np.float64),
                                              se3np.inv(np.asarray(Tb, np.float64)))))


@pytest.fixture(scope="module")
def inputs():
    cam = PinholeCamera(320, 240, 200.0, 200.0, 160.0, 120.0)
    scene = PlaneScene(cam, z0=2.0, extent=2.5, seed=3, tex_size=1024)
    pb = testing.track_problem(cam, scene, T_CUR, p_max=P_MAX)
    prev = jax_pyramids(jnp.asarray(pb["img_prev"]))
    win, anc = memoize_level_windows(prev["pyr"][:3], jnp.asarray(pb["px"]),
                                     jnp.zeros(P_MAX, jnp.int32))
    np.testing.assert_array_equal(np.asarray(anc), pb["anchor"])
    pt_pack = np.concatenate([np.asarray(win).reshape(P_MAX, -1), pb["cols"]], axis=1)
    assert pt_pack.shape == (P_MAX, PT_COLS)
    snap = {k: pb[k] for k in ("pos_w", "kf_poses", "kf_exposure", "ring_T", "ring_exp",
                               "species", "light")}
    snap["pt_pack"] = pt_pack
    k = min(pb["n_obs"], C)
    obs = dict(px=np.zeros((C, 2), np.float32),
               f=np.tile([0.0, 0.0, 1.0], (C, 1)).astype(np.float32),
               pid=np.zeros(C, np.int32), valid=np.zeros(C, bool))
    obs["px"][:k], obs["f"][:k], obs["pid"][:k] = (pb["obs_px"][:k], pb["obs_f"][:k],
                                                   pb["obs_pid"][:k])
    obs["valid"][:k] = True
    return dict(cam=cam, pb=pb, snap=snap, obs=obs, prev_jax=prev,
                T_prev=se3np.identity().astype(np.float32))


@pytest.fixture(scope="module")
def jax_out(inputs):
    i = inputs
    cam_j = JaxPinhole(320, 240, 200.0, 200.0, 160.0, 120.0)
    step = make_frame_step(cam_j, *STEP_ARGS, n_obs_pad=C)
    prev = i["prev_jax"]
    out = step(jnp.asarray(i["pb"]["img_cur"]), prev["pyr"], prev["grad_mean"],
               jnp.asarray(i["T_prev"]), {k: jnp.asarray(v) for k, v in i["obs"].items()},
               prev["intensity_mean"], jnp.float32(1.0), jnp.asarray(i["T_prev"]),
               {k: jnp.asarray(v) for k, v in i["snap"].items()}, empty_seeds(16),
               jnp.float32(0.0025), jnp.zeros((2, P_MAX), jnp.int32))
    return jax.tree.map(np.asarray, out)


def _run_torch(i):
    step = make_track_step(i["cam"], *STEP_ARGS, n_obs_pad=C, device="cpu")
    prev = build_frame_pyramids(i["pb"]["img_prev"], device="cpu")
    return step(i["pb"]["img_cur"], prev["pyr"], prev["grad_mean"], torch.as_tensor(i["T_prev"]),
                prev_obs_from_numpy(i["obs"], "cpu"), prev["intensity_mean"], 1.0,
                torch.as_tensor(i["T_prev"]), snapshot_from_numpy(i["snap"], "cpu"),
                torch.zeros((2, P_MAX), dtype=torch.int32))


@pytest.fixture(scope="module")
def torch_out(inputs):
    return _run_torch(inputs)


def test_output_keys(jax_out, torch_out):
    assert set(jax_out) - set(torch_out) == set(SEED_KEYS)
    assert set(torch_out) - set(jax_out) == {"used_fc"}
    # the FC/IC choice is a device bool (an IF node when the step is a CUDA graph)
    used_fc = torch_out["used_fc"]
    assert isinstance(used_fc, torch.Tensor) and used_fc.dtype == torch.bool
    assert used_fc.shape == () and not used_fc.item()


def test_poses_and_exposure(jax_out, torch_out):
    for k in ("T_track", "T_new"):
        assert _se3_dist(_np(torch_out[k]), jax_out[k]) < 1e-3, k
    assert _se3_dist(_np(torch_out["T_new"]), T_CUR) < 2e-3          # and it is right
    for k in ("exposure", "exposure_ratio"):
        assert abs(float(torch_out[k]) - float(jax_out[k])) < 1e-3, k
    assert int(torch_out["n_tracked"]) == int(jax_out["n_tracked"]) > 50


def test_selection_exact(jax_out, torch_out):
    assert jax_out["cv1"].sum() > 100
    for k in ("cv1", "cp1", "cp2", "cid", "species", "level"):
        np.testing.assert_array_equal(_np(torch_out[k]), jax_out[k], err_msg=k)
        assert _np(torch_out[k]).dtype == jax_out[k].dtype, k


def test_matches_and_inliers(jax_out, torch_out):
    for k in ("success", "inlier", "s1", "tried2", "s2_used"):
        agree = (_np(torch_out[k]) == jax_out[k]).mean()
        assert agree >= 0.95, (k, agree)
    both = _np(torch_out["success"]) & jax_out["success"]
    assert both.sum() > 100
    np.testing.assert_allclose(_np(torch_out["px"])[both], jax_out["px"][both], atol=1e-2)
    np.testing.assert_allclose(_np(torch_out["f_cur"])[both], jax_out["f_cur"][both], atol=1e-4)
    np.testing.assert_allclose(_np(torch_out["grad_cur"])[both], jax_out["grad_cur"][both],
                               atol=1e-4)
    for k in ("n_matches", "n_inliers"):
        assert abs(int(torch_out[k]) - int(jax_out[k])) <= 0.05 * C, k
    for k in ("depth_mean", "depth_min", "distance_mean"):
        np.testing.assert_allclose(float(torch_out[k]), float(jax_out[k]), rtol=1e-3, err_msg=k)
    np.testing.assert_allclose(float(torch_out["err_px"]), float(jax_out["err_px"]),
                               rtol=0.05, atol=1e-3)


def test_acc_and_packed(jax_out, torch_out):
    acc_t, acc_j = _np(torch_out["acc"]), jax_out["acc"]
    assert acc_t.dtype == acc_j.dtype and acc_t.shape == acc_j.shape
    assert (acc_t != acc_j).sum() <= 0.05 * C
    assert acc_j.sum() == jax_out["cv1"].sum() + jax_out["tried2"].sum()
    assert acc_t.sum() == _np(torch_out["cv1"]).sum() + _np(torch_out["tried2"]).sum()
    packed_t, packed_j = _np(torch_out["packed"]), jax_out["packed"]
    assert packed_t.shape == packed_j.shape == (24,)
    assert packed_t[19] == 0.0                      # seeds updated: the sweep is not ported
    keep = np.arange(24) != 19
    np.testing.assert_allclose(packed_t[keep][:12], packed_j[keep][:12], atol=1e-3)
    np.testing.assert_allclose(packed_t[keep][12:], packed_j[keep][12:], rtol=0.05, atol=1e-3)
    sp_t, sp_j = _np(torch_out["slot_pack"]), jax_out["slot_pack"]
    assert sp_t.shape == sp_j.shape == (C, 11)
    same = _np(torch_out["success"]) == jax_out["success"]
    np.testing.assert_array_equal(sp_t[same][:, 7:10], sp_j[same][:, 7:10])
    obs_t = torch_out["obs_next"]
    assert {k: tuple(v.shape) for k, v in obs_t.items()} == {
        k: v.shape for k, v in jax_out["obs_next"].items()}
    np.testing.assert_array_equal(_np(obs_t["pid"]), jax_out["obs_next"]["pid"])


def test_step_is_deterministic(inputs, torch_out):
    again = _run_torch(inputs)
    for k in ("packed", "slot_pack", "acc", "T_new", "px", "success", "inlier", "cid"):
        assert torch.equal(again[k], torch_out[k]), k


def test_retry_pass_and_padding(inputs):
    """Kill the best candidate's appearance in a third of the cells so the
    runner-up pass has work, pad obs_next beyond C, and seed ``acc``."""
    i = dict(inputs)
    snap = dict(i["snap"])
    pack = snap["pt_pack"].copy()
    rs = np.random.RandomState(0)
    hit = rs.rand(P_MAX) < 0.3
    pack[hit, :576] = rs.uniform(0, 255, (int(hit.sum()), 576)).astype(np.float32)
    snap["pt_pack"] = pack
    cam_j = JaxPinhole(320, 240, 200.0, 200.0, 160.0, 120.0)
    acc0 = rs.randint(0, 5, (2, P_MAX)).astype(np.int32)
    prev = i["prev_jax"]
    n_pad = C + 8
    pad = lambda a: np.concatenate([a, np.zeros((8,) + a.shape[1:], a.dtype)])   # noqa: E731
    obs = {k: pad(v) for k, v in i["obs"].items()}
    ref = jax.tree.map(np.asarray, make_frame_step(cam_j, *STEP_ARGS, n_obs_pad=n_pad)(
        jnp.asarray(i["pb"]["img_cur"]), prev["pyr"], prev["grad_mean"], jnp.asarray(i["T_prev"]),
        {k: jnp.asarray(v) for k, v in obs.items()}, prev["intensity_mean"], jnp.float32(1.0),
        jnp.asarray(i["T_prev"]), {k: jnp.asarray(v) for k, v in snap.items()}, empty_seeds(16),
        jnp.float32(0.0025), jnp.asarray(acc0)))
    prev_t = build_frame_pyramids(i["pb"]["img_prev"], device="cpu")
    out = make_track_step(i["cam"], *STEP_ARGS, n_obs_pad=n_pad, device="cpu")(
        i["pb"]["img_cur"], prev_t["pyr"], prev_t["grad_mean"], torch.as_tensor(i["T_prev"]),
        prev_obs_from_numpy(obs, "cpu"), prev_t["intensity_mean"], 1.0,
        torch.as_tensor(i["T_prev"]), snapshot_from_numpy(snap, "cpu"), torch.as_tensor(acc0))
    assert ref["tried2"].sum() >= 10 and ref["s2_used"].sum() >= 5
    for k in ("cv1", "cp1", "cp2"):
        np.testing.assert_array_equal(_np(out[k]), ref[k], err_msg=k)
    for k in ("s1", "tried2", "s2_used", "success", "inlier"):
        assert (_np(out[k]) == ref[k]).mean() >= 0.95, k
    same = (_np(out["s2_used"]) == ref["s2_used"]) & (_np(out["s1"]) == ref["s1"])
    np.testing.assert_array_equal(_np(out["cid"])[same], ref["cid"][same])
    assert _se3_dist(_np(out["T_new"]), ref["T_new"]) < 1e-3
    assert (_np(out["acc"]) != ref["acc"]).sum() <= 0.05 * C
    assert tuple(out["obs_next"]["px"].shape) == (n_pad, 2) == ref["obs_next"]["px"].shape
    assert not _np(out["obs_next"]["valid"])[C:].any()


def test_patch_closest_option(inputs):
    """``patch_closest`` picks, per candidate, the stored view with the
    smaller viewing angle: the host view here is the same patch filed under
    a keyframe whose camera centre lies off to the side, so the choice
    differs from row to row and both sides must make it alike."""
    i = inputs
    snap = dict(i["snap"])
    host = snap["pt_pack"].copy()
    host[:, 576 + 11] = 1.0                       # host view: keyframe 1
    poses = snap["kf_poses"].copy()
    poses[1] = se3np.exp(np.array([0.05, 0.0, 0.0, 0.0, 0.0, 0.0])).astype(np.float32)
    snap["kf_poses"], snap["host_pack"] = poses, host
    cam_j = JaxPinhole(320, 240, 200.0, 200.0, 160.0, 120.0)
    prev = i["prev_jax"]
    ref = jax.tree.map(np.asarray, make_frame_step(
        cam_j, *STEP_ARGS, n_obs_pad=C, patch_closest=True)(
        jnp.asarray(i["pb"]["img_cur"]), prev["pyr"], prev["grad_mean"], jnp.asarray(i["T_prev"]),
        {k: jnp.asarray(v) for k, v in i["obs"].items()}, prev["intensity_mean"],
        jnp.float32(1.0), jnp.asarray(i["T_prev"]), {k: jnp.asarray(v) for k, v in snap.items()},
        empty_seeds(16), jnp.float32(0.0025), jnp.zeros((2, P_MAX), jnp.int32)))
    prev_t = build_frame_pyramids(i["pb"]["img_prev"], device="cpu")
    out = make_track_step(i["cam"], *STEP_ARGS, n_obs_pad=C, patch_closest=True, device="cpu")(
        i["pb"]["img_cur"], prev_t["pyr"], prev_t["grad_mean"], torch.as_tensor(i["T_prev"]),
        prev_obs_from_numpy(i["obs"], "cpu"), prev_t["intensity_mean"], 1.0,
        torch.as_tensor(i["T_prev"]), snapshot_from_numpy(snap, "cpu"),
        torch.zeros((2, P_MAX), dtype=torch.int32))
    same = (_np(out["s2_used"]) == ref["s2_used"]) & (_np(out["s1"]) == ref["s1"])
    assert same.mean() >= 0.95
    np.testing.assert_array_equal(_np(out["cid"])[same], ref["cid"][same])
    assert (_np(out["success"]) == ref["success"]).mean() >= 0.95
    assert _se3_dist(_np(out["T_new"]), ref["T_new"]) < 1e-3
    # the mis-filed host views cost matches on both sides alike
    assert ref["n_inliers"] > 30
    assert (_np(out["inlier"]) == ref["inlier"]).mean() >= 0.95


def test_pack_light_layout():
    t = np.array([0, 1, 4, 3], np.int32)
    v = np.array([False, True, True, False])
    np.testing.assert_array_equal(pack_light(t, v), [0, 9, 12, 3])

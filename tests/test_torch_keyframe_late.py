"""The keyframe work of the evolving-map scan at a late event: the port's
``keyframe_work`` against the JAX package's keyframe body
(``bench.py:375-527``, kept line for line in ``tests/scan_reference_jax.py``)
on the CPU, on a state that the first event never reaches.

Input: the port's own scan (``run_scan``) from ``artifacts/bench_boot.npz``
over the first 77 frames of the benchmark's trajectory (12 keyframe events),
then the step of frame 77 (the 13th event, keyframe 18).  Both bodies run on
that carry and that step output (the JAX one on a copy in ``jnp``).  At this
event the window is full (base 3 > 0): a column is evicted, the oldest
``N_FIX_GAUGE`` keyframes are held fixed, and the 512-row activation ring has
wrapped, so the BA reads rows that an activation reused and the activation
writes over live rows again.

Tolerances are those of ``tests/test_torch_keyframe.py``: selection and
copied members exact, poses 1e-5, inverse distances and positions 1e-4
relative, chi2 1e-3 relative, seeds as in ``tests/test_torch_depth_filter.py``.
Not compared, because the port does not copy two faults of the JAX bench
(ROADMAP §3): the trash row (reset by the port only), and the observation
cells of the rows this event activates into.  The port empties them; the
bench leaves the cells of the point that held the row before, and its next
BA holds the new point to them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke as cs
from hso_tpu_torch.config import Config
from hso_tpu_torch.pipeline import keyframe as kfw
from hso_tpu_torch.pipeline import scan
from hso_tpu_torch.utils.checkpoint import scan_state_from_checkpoint
from scan_reference_jax import JaxScan

torch.set_num_threads(1)

N_FRAMES = 78            #: frames of the port's scan; the last one is the late event
OUT_KEYS = ("T_new", "exposure", "success", "inlier", "cid", "f_cur", "grad_cur", "species",
            "level", "px", "depth_mean", "depth_min")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _j(x, like=None):
    return jnp.asarray(x.numpy(), dtype=None if like is None else like.dtype)


@pytest.fixture(scope="module")
def late():
    cam, cfg = cs.bench_camera(), Config()
    carry, meta = scan_state_from_checkpoint(cs.BOOT_NPZ, cam, cfg, "cpu")
    fc = meta["frame_count"]
    frames = cs.render_frames(cs.bench_scene(cam), cs.trajectory(fc + N_FRAMES)[fc:])
    kept = {}

    def on_frame(i, kf, out, carry_i):
        if i == N_FRAMES - 2:
            kept["carry"] = carry_i
        elif i == N_FRAMES - 1:
            kept["out"] = out

    assert scan.is_keyframe(N_FRAMES - 1)
    scan.run_scan(scan.make_scan_step(cam, cfg, "cpu"), carry, frames, cam, cfg,
                  meta["px_error_angle"], on_frame=on_frame)
    st, out = kept["carry"]["st"], kept["out"]
    res = kfw.keyframe_work(st, out["seeds"], out, cam, cfg)

    js = JaxScan(cs.BOOT_NPZ)
    c0 = js.carry0()
    st_j = {k: _j(v, c0[8][k]) if isinstance(v, torch.Tensor) else jnp.int32(v)
            for k, v in st.items()}
    seeds_j = {k: _j(v, c0[6][k]) for k, v in out["seeds"].items()}
    out_j = {k: _j(out[k]) for k in OUT_KEYS}
    d = out["data"]
    out_j["data"] = {"pyr": tuple(_j(p) for p in d["pyr"]),
                     "sobel_x": tuple(_j(p) for p in d["sobel_x"]),
                     "sobel_y": tuple(_j(p) for p in d["sobel_y"]),
                     "grad_mean": _j(d["grad_mean"])}
    st_r, seeds_r, chk_r, extra = js.kf_work(out_j, st_j, seeds_j)
    ref = dict(st=jax.tree.map(np.asarray, st_r), seeds=jax.tree.map(np.asarray, seeds_r),
               chk=float(chk_r), rows_b=np.asarray(extra["rows_b"]),
               rows=np.asarray(extra["rows"]),
               chi2=(float(extra["ba"]["chi2_init"]), float(extra["ba"]["chi2_final"])))
    return dict(st_in=st, torch=res, jax=ref)


def test_the_state_is_late(late):
    st = late["st_in"]
    p0 = st["light"].shape[0] - kfw.R_RES - 1
    kw = Config().n_kfs_window
    assert st["kf_count"] + 1 - kw > 0, "the window is not full yet"
    assert (_np(st["light"])[p0:p0 + kfw.R_RES] >= 8).all(), "the activation ring is not full"
    # the ring has wrapped: its rows were first written 0, 1, ... and the
    # cursor has come round to below the rows already written
    assert 0 < int(st["cursor"]) < kfw.R_RES
    stats = late["torch"][3]
    assert int(stats["activated"]) > 0
    # the BA reads rows of the ring, and some of them hold observation cells
    rows_b = _np(stats["rows_b"])[:int(stats["ba_points"])]
    ring = rows_b[rows_b >= p0]
    assert ring.size > 0 and (_np(st["ba_pack"])[ring, :, 6] > 0.5).any()


def test_compaction_and_activation_rows_are_exact(late):
    stats = late["torch"][3]
    np.testing.assert_array_equal(_np(stats["rows_b"]), late["jax"]["rows_b"])
    np.testing.assert_array_equal(_np(stats["rows_act"]), late["jax"]["rows"])


def _activated_rows(late):
    """The point rows this event's activations were written to."""
    st, stats = late["st_in"], late["torch"][3]
    p0 = st["light"].shape[0] - kfw.R_RES - 1
    n_act = int(stats["activated"])
    return p0 + (int(st["cursor"]) + np.arange(n_act)) % kfw.R_RES


def test_activated_rows_start_without_the_old_points_cells(late):
    rows = _activated_rows(late)
    assert not _np(late["torch"][0]["ba_pack"])[rows].any()
    # the JAX bench keeps them (the fault the port does not copy)
    assert (late["jax"]["st"]["ba_pack"][rows, :, 6] > 0.5).any()
    keep = np.ones(late["st_in"]["light"].shape[0] - 1, bool)
    keep[rows] = False
    np.testing.assert_array_equal(_np(late["torch"][0]["ba_pack"])[:-1][keep],
                                  late["jax"]["st"]["ba_pack"][:-1][keep])


@pytest.mark.parametrize("key", ["light", "host_kf", "species", "f_host", "pt_pack",
                                 "ring_T", "ring_exp", "ring_kf", "kf_exposure"])
def test_integer_and_copied_members_are_exact(late, key):
    st_t, st_j = late["torch"][0], late["jax"]["st"]
    rows = slice(None, -1) if st_j[key].shape[0] == st_j["light"].shape[0] else slice(None)
    np.testing.assert_array_equal(_np(st_t[key])[rows], st_j[key][rows], err_msg=key)


def test_counters_and_cursor(late):
    st_t, st_j = late["torch"][0], late["jax"]["st"]
    assert st_t["kf_count"] == int(st_j["kf_count"]) == late["st_in"]["kf_count"] + 1
    assert st_t["batch"] == int(st_j["batch"])
    assert int(st_t["cursor"]) == int(st_j["cursor"])
    n_act = int(late["torch"][3]["activated"])
    assert int(st_t["cursor"]) == (int(late["st_in"]["cursor"]) + n_act) % kfw.R_RES


def test_ba_write_back(late):
    st_t, st_j = late["torch"][0], late["jax"]["st"]
    np.testing.assert_allclose(_np(st_t["kf_poses"]), st_j["kf_poses"], atol=1e-5)
    np.testing.assert_allclose(_np(st_t["idist"])[:-1], st_j["idist"][:-1], rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(_np(st_t["pos_w"])[:-1], st_j["pos_w"][:-1], rtol=1e-4, atol=1e-5)
    ci, cf = late["jax"]["chi2"]
    stats = late["torch"][3]
    np.testing.assert_allclose(float(stats["chi2_init"]), ci, rtol=1e-3)
    np.testing.assert_allclose(float(stats["chi2_final"]), cf, rtol=1e-3)
    assert cf <= ci and float(stats["chi2_final"]) <= float(stats["chi2_init"])
    # the oldest N_FIX_GAUGE keyframes of the window are held, the newer move
    kf = late["st_in"]["kf_count"]
    base = kf + 1 - Config().n_kfs_window
    moved = np.abs(_np(st_t["kf_poses"]) - _np(late["st_in"]["kf_poses"])).max(axis=(1, 2))
    assert moved[:base + kfw.N_FIX_GAUGE].max() == 0.0
    assert moved[base + kfw.N_FIX_GAUGE:kf].min() > 0 and moved[kf + 1:].max() == 0.0


def test_seeds(late):
    s_t, s_j = late["torch"][1], late["jax"]["seeds"]
    for k in ("valid", "host", "level", "species", "batch_id", "host_anchor", "obs_count",
              "temp_point", "px", "grad", "host_win", "obs_valid"):
        np.testing.assert_array_equal(_np(s_t[k]), s_j[k], err_msg=k)
    np.testing.assert_allclose(_np(s_t["f"]), s_j["f"], atol=1e-6)
    for k in ("mu", "sigma2", "z_range", "converge_thresh", "a", "b", "n_updates"):
        np.testing.assert_allclose(_np(s_t[k]), s_j[k], rtol=1e-5, atol=1e-7, err_msg=k)
    assert int(late["torch"][3]["seeds_initialised"]) > 0
    np.testing.assert_allclose(float(late["torch"][2]), late["jax"]["chk"], rtol=1e-5)

"""The keyframe work of the evolving-map scan: the port's ``keyframe_work``
against the JAX package's keyframe body (``bench.py:375-527``, kept line for
line in ``tests/scan_reference_jax.py``) on the CPU.

Input: the scan's start state from ``artifacts/bench_boot.npz`` (pinhole
640×480, default config, 4,096 point rows + a 512-row activation ring + the
trash row, 1,024 seed slots, the last 6 keyframes in the 16-column BA ring)
and ONE output of the JAX ``make_frame_step`` on the next frame of the
benchmark's trajectory, rendered by the port's box scene.  Both bodies run on
that output (the port's on its numpy copy).  The start states are compared
first: the port builds its own (``scan_state_from_checkpoint``).

Tolerances, and why.  Selection is integer work and exact: the compaction
rows, the activation rows, the observation ring, the light words, the host
keyframes, the cursor, the activated point rows.  The BA is float32 in
another order of sums: poses to 1e-5, inverse distances and re-anchored
positions to 1e-4 relative (``tests/test_torch_local_ba.py``).  Seeds as in
``tests/test_torch_depth_filter.py``: integer members exact.

One row is not compared: the last (trash) row, which absorbs the masked
writes.  The JAX body resets it only in the observation ring; its other
tables keep whatever the last masked write put there (the light word of a
valid candidate, for one).  The port resets the whole row to an empty one.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke as cs
from hso_tpu_torch.config import Config
from hso_tpu_torch.pipeline import keyframe as kfw
from hso_tpu_torch.utils.checkpoint import scan_state_from_checkpoint
from scan_reference_jax import JaxScan

torch.set_num_threads(1)

OUT_KEYS = ("T_new", "exposure", "success", "inlier", "cid", "f_cur", "grad_cur", "species",
            "level", "px", "depth_mean", "depth_min")
ST_EXACT = ("light", "pt_pack", "species", "kf_exposure", "ring_T", "ring_exp", "ring_kf",
            "f_host", "host_kf", "ba_pack")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def world():
    cam, cfg = cs.bench_camera(), Config()
    js = JaxScan(cs.BOOT_NPZ)
    carry, meta = scan_state_from_checkpoint(cs.BOOT_NPZ, cam, cfg, "cpu")
    fc = meta["frame_count"]
    img = cs.bench_scene(cam).render(cs.trajectory(fc + 1)[fc])
    carry_j = js.carry0()
    out_j = js.frame_step(carry_j, jnp.asarray(img))
    return dict(cam=cam, cfg=cfg, js=js, carry=carry, carry_j=carry_j, out_j=out_j)


def _out_torch(out_j):
    out = {k: _t(out_j[k]) for k in OUT_KEYS}
    d = out_j["data"]
    out["data"] = {"pyr": tuple(_t(p) for p in d["pyr"]),
                   "sobel_x": tuple(_t(p) for p in d["sobel_x"]),
                   "sobel_y": tuple(_t(p) for p in d["sobel_y"]),
                   "grad_mean": _t(d["grad_mean"])}
    return out


def _seeds_torch(seeds_j, like):
    return {k: _t(seeds_j[k]).to(v.dtype) for k, v in like.items()}


@pytest.fixture(scope="module")
def both(world):
    js, out_j = world["js"], world["out_j"]
    st_j, seeds_j, chk_j, extra = js.kf_work(out_j, world["carry_j"][8], out_j["seeds"])
    jax_res = dict(st=jax.tree.map(np.asarray, st_j), seeds=jax.tree.map(np.asarray, seeds_j),
                   chk=float(chk_j), rows_b=np.asarray(extra["rows_b"]),
                   rows=np.asarray(extra["rows"]),
                   chi2=(float(extra["ba"]["chi2_init"]), float(extra["ba"]["chi2_final"])))
    out_t = _out_torch(out_j)
    seeds_in = _seeds_torch(out_j["seeds"], world["carry"]["seeds"])
    st_in = world["carry"]["st"]
    st_before = {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in st_in.items()}
    res = kfw.keyframe_work(st_in, seeds_in, out_t, world["cam"], world["cfg"])
    return dict(jax=jax_res, torch=res, out_t=out_t, seeds_in=seeds_in, st_in=st_in,
                st_before=st_before)


def test_scan_state_is_the_bench_state(world):
    st_j = jax.tree.map(np.asarray, world["carry_j"][8])
    st_t = world["carry"]["st"]
    assert set(st_t) == set(st_j)
    for k in ST_EXACT + ("idist", "kf_poses", "cursor"):
        np.testing.assert_array_equal(_np(st_t[k]), st_j[k], err_msg=k)
        assert _np(st_t[k]).dtype == st_j[k].dtype, k
    np.testing.assert_allclose(_np(st_t["pos_w"]), st_j["pos_w"], rtol=1e-6, atol=1e-6)
    assert st_t["kf_count"] == int(st_j["kf_count"]) == 6
    assert st_t["batch"] == int(st_j["batch"]) == 5
    p_t = st_t["light"].shape[0]
    assert p_t == 4096 + kfw.R_RES + 1
    assert world["carry"]["acc"].shape == (2, p_t)


def test_compaction_and_activation_rows_are_exact(both):
    stats = both["torch"][3]
    np.testing.assert_array_equal(_np(stats["rows_b"]), both["jax"]["rows_b"])
    np.testing.assert_array_equal(_np(stats["rows_act"]), both["jax"]["rows"])
    assert int(stats["ba_points"]) > 200
    assert int(stats["activated"]) > 0


@pytest.mark.parametrize("key", ["ba_pack", "light", "host_kf", "species", "f_host", "ring_T",
                                 "ring_exp", "ring_kf", "kf_exposure"])
def test_integer_and_copied_members_are_exact(both, key):
    st_t, st_j = both["torch"][0], both["jax"]["st"]
    rows = slice(None, -1) if st_j[key].shape[0] == st_j["light"].shape[0] else slice(None)
    np.testing.assert_array_equal(_np(st_t[key])[rows], st_j[key][rows], err_msg=key)


def test_counters_and_cursor(both):
    st_t, st_j = both["torch"][0], both["jax"]["st"]
    assert st_t["kf_count"] == int(st_j["kf_count"]) == 7
    assert st_t["batch"] == int(st_j["batch"]) == 6
    assert int(st_t["cursor"]) == int(st_j["cursor"]) == int(both["torch"][3]["activated"])


def test_activated_point_rows_are_exact(both):
    st_t, st_j = both["torch"][0], both["jax"]["st"]
    p0, n = 4096, int(st_t["cursor"])
    rows = slice(p0, p0 + n)
    np.testing.assert_array_equal(_np(st_t["pt_pack"])[rows], st_j["pt_pack"][rows])
    np.testing.assert_array_equal(_np(st_t["pt_pack"])[:-1], st_j["pt_pack"][:-1])
    assert (_np(st_t["light"])[rows] == kfw.TYPE_CAND_VALID).all()


def test_trash_row_is_reset(both):
    st_t = both["torch"][0]
    assert int(st_t["light"][-1]) == 0 and int(st_t["host_kf"][-1]) == -1
    for k in ("pos_w", "pt_pack", "f_host", "idist", "ba_pack"):
        assert not _np(st_t[k])[-1].any(), k


def test_ba_write_back(both):
    st_t, st_j = both["torch"][0], both["jax"]["st"]
    np.testing.assert_allclose(_np(st_t["kf_poses"]), st_j["kf_poses"], atol=1e-5)
    np.testing.assert_allclose(_np(st_t["idist"])[:-1], st_j["idist"][:-1], rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(_np(st_t["pos_w"])[:-1], st_j["pos_w"][:-1], rtol=1e-4, atol=1e-5)
    ci, cf = both["jax"]["chi2"]
    stats = both["torch"][3]
    np.testing.assert_allclose(float(stats["chi2_init"]), ci, rtol=1e-3)
    np.testing.assert_allclose(float(stats["chi2_final"]), cf, rtol=1e-3)
    assert cf <= ci and float(stats["chi2_final"]) <= float(stats["chi2_init"])
    # window 6 - 15 .. 6: keyframe 0 is held fixed, 1 - 5 move, 6 is new,
    # rows past it are untouched
    moved = np.abs(_np(st_t["kf_poses"]) - _np(both["st_before"]["kf_poses"])).max(axis=(1, 2))
    assert moved[0] == 0.0 and moved[1:6].min() > 0 and moved[7:].max() == 0.0


def test_seeds(both):
    s_t, s_j = both["torch"][1], both["jax"]["seeds"]
    for k in ("valid", "host", "level", "species", "batch_id", "host_anchor", "obs_count",
              "temp_point", "px", "grad", "host_win", "obs_valid"):
        np.testing.assert_array_equal(_np(s_t[k]), s_j[k], err_msg=k)
    np.testing.assert_allclose(_np(s_t["f"]), s_j["f"], atol=1e-6)
    for k in ("mu", "sigma2", "z_range", "converge_thresh", "a", "b", "n_updates"):
        np.testing.assert_allclose(_np(s_t[k]), s_j[k], rtol=1e-5, atol=1e-7, err_msg=k)
    assert int(both["torch"][3]["seeds_initialised"]) > 0
    np.testing.assert_allclose(float(both["torch"][2]), both["jax"]["chk"], rtol=1e-5)


def test_inputs_untouched_and_second_run_bitwise_equal(world, both):
    for k, v in both["st_before"].items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(both["st_in"][k], v), k
        else:
            assert both["st_in"][k] == v, k
    again = kfw.keyframe_work(both["st_in"], both["seeds_in"], both["out_t"], world["cam"],
                              world["cfg"])
    for k, v in both["torch"][0].items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(again[0][k], v), k
    for k, v in both["torch"][1].items():
        assert torch.equal(again[1][k], v), k
    assert torch.equal(again[2], both["torch"][2])


@pytest.mark.parametrize("seed,n,k,frac", [(0, 100, 30, 0.2), (1, 100, 30, 0.5),
                                           (2, 4609, 2048, 0.15), (3, 1024, 64, 0.02),
                                           (4, 64, 64, 1.0), (5, 50, 10, 0.0)])
def test_first_rows_is_the_bench_top_k(seed, n, k, frac):
    cand = np.random.default_rng(seed).random(n) < frac
    _, ref = jax.lax.top_k(jnp.where(jnp.asarray(cand), n - jnp.arange(n), 0), k)
    got = kfw.first_rows(torch.as_tensor(cand), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

"""The whole per-frame step: ``make_frame_step`` of the port against the JAX
``make_frame_step`` on the CPU, for one frame at full width resumed from
``artifacts/bench_boot.npz`` (pinhole 640×480, default config, 336 cells,
4096 point rows, 1024 seed slots of which 151 are live), the frame rendered
by the port's box scene at the next pose of the benchmark's trajectory.

The JAX side is the live pipeline's own chain (``FrameHandler`` +
``load_checkpoint`` + its fused step); the port reads the checkpoint with
``frame_state_from_checkpoint``.  On the CPU the port runs the plain versions
of all six kernels.

Tolerances, and why: both sides are float32 and sum in different orders.
``T_new`` entries agree to 1e-6 (measured 3e-7: a few float32 steps of a
translation of order 1); selection is integer work and exact; the packed
scalars to 1e-4 relative; seed members as in ``tests/test_torch_depth_filter.py``
(``mu`` 1e-3, matched pixel 2e-2, at most 2 rows matched by one side only);
``sigma2`` to 0.5 % relative: the fused variance follows the triangulation
uncertainty, a difference of two nearly equal depths over a baseline of a few
centimetres, which magnifies the 1e-4 px difference of the match.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke as cs
from hso_tpu.cameras import PinholeCamera as JaxPinhole
from hso_tpu.config import Config as JaxConfig
from hso_tpu_torch.config import Config
from hso_tpu_torch.mapping.depth_filter import empty_seeds
from hso_tpu_torch.pipeline import fused_step
from hso_tpu_torch.utils.checkpoint import frame_state_from_checkpoint

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED_KEYS = ("seeds", "n_seeds_updated", "seed_match_px", "seed_matched", "kf_pack")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def world():
    cam, cfg = cs.bench_camera(), Config()
    st = frame_state_from_checkpoint(cs.BOOT_NPZ, cam, cfg, "cpu")
    frame_count = st[7]
    img = cs.bench_scene(cam).render(cs.trajectory(frame_count + 1)[frame_count])
    return dict(cam=cam, cfg=cfg, state=st, img=img)


def _run_torch(world, whole=True):
    cam, cfg = world["cam"], world["cfg"]
    (snap, prev_pyr, gm, im, ex, T_prev, prev_obs, _, seeds, _, _, px_err) = world["state"]
    step, _, _ = cs.build_step(cam, cfg, torch.device("cpu"), whole=whole)
    acc = torch.zeros((2, snap["pos_w"].shape[0]), dtype=torch.int32)
    head = (world["img"], prev_pyr, gm, T_prev, prev_obs, im, ex, torch.eye(3, 4), snap)
    return step(*head, seeds, px_err, acc) if whole else step(*head, acc)


@pytest.fixture(scope="module")
def torch_out(world):
    return _run_torch(world)


@pytest.fixture(scope="module")
def jax_out(world):
    from hso_tpu.pipeline.frame_handler import FrameHandler
    from hso_tpu.utils.checkpoint import load_checkpoint

    vo = FrameHandler(JaxPinhole(640, 480, 400.0, 400.0, 320.0, 240.0), JaxConfig())
    load_checkpoint(vo, cs.BOOT_NPZ, resume_stage="default")
    last = vo.last_frame
    out = vo._fused_step()(
        jnp.asarray(world["img"]), last.data["pyr"], jnp.float32(last.grad_mean),
        jnp.asarray(last.T_f_w, jnp.float32), vo._prev_obs_dev(last),
        jnp.float32(last.intensity_mean), jnp.float32(last.exposure),
        jnp.asarray(np.eye(3, 4), jnp.float32), vo._snapshot(), vo.seeds,
        jnp.float32(vo.px_error_angle), jnp.zeros((2, vo.points.p_max), jnp.int32))
    return jax.tree.map(np.asarray, out)


def test_same_dict_keys(jax_out, torch_out):
    assert set(torch_out) - set(jax_out) == {"used_fc"}
    assert set(jax_out) <= set(torch_out)
    assert set(SEED_KEYS) <= set(torch_out)
    # the JAX loader files ``seed_ring`` into its seed dict; the port's table
    # has the members of ``empty_seeds`` only
    assert set(jax_out["seeds"]) - set(torch_out["seeds"]) == {"ring"}
    assert set(torch_out["seeds"]) == set(empty_seeds(4, "cpu"))
    for k, v in torch_out["seeds"].items():
        assert _np(v).dtype == jax_out["seeds"][k].dtype and _np(v).shape == \
            jax_out["seeds"][k].shape, k


def test_pose_and_selection(jax_out, torch_out):
    np.testing.assert_allclose(_np(torch_out["T_new"]), jax_out["T_new"], atol=1e-6)
    np.testing.assert_allclose(_np(torch_out["T_track"]), jax_out["T_track"], atol=1e-6)
    for k in ("cv1", "cp1", "cp2", "cid", "species", "level", "success", "inlier", "s1",
              "tried2", "s2_used"):
        np.testing.assert_array_equal(_np(torch_out[k]), jax_out[k], err_msg=k)
    assert int(torch_out["n_inliers"]) == int(jax_out["n_inliers"]) > 200


def test_packed_and_kf_pack_layout(jax_out, torch_out):
    packed_t, packed_j = _np(torch_out["packed"]), jax_out["packed"]
    assert packed_t.shape == packed_j.shape == (24,)
    np.testing.assert_allclose(packed_t, packed_j, rtol=1e-4, atol=1e-5)
    assert packed_t[19] == float(torch_out["n_seeds_updated"]) == packed_j[19] > 100
    kf_t, kf_j = _np(torch_out["kf_pack"]), jax_out["kf_pack"]
    C, P, S = 336, 4096, 1024
    assert kf_t.shape == kf_j.shape == (C * 11 + 2 * P + 3 * S,) and kf_t.dtype == np.float32
    # [slot_pack (C·11) | acc (2P) | seed_match_px (2S) | seed_matched (S)]
    o = 0
    np.testing.assert_array_equal(kf_t[o:o + C * 11], _np(torch_out["slot_pack"]).reshape(-1))
    np.testing.assert_allclose(kf_t[o:o + C * 11], kf_j[o:o + C * 11], rtol=1e-4, atol=1e-2)
    o += C * 11
    np.testing.assert_array_equal(kf_t[o:o + 2 * P], _np(torch_out["acc"]).reshape(-1))
    np.testing.assert_array_equal(kf_t[o:o + 2 * P], kf_j[o:o + 2 * P])
    o += 2 * P
    np.testing.assert_array_equal(kf_t[o:o + 2 * S],
                                  _np(torch_out["seed_match_px"]).reshape(-1))
    o += 2 * S
    np.testing.assert_array_equal(kf_t[o:], _np(torch_out["seed_matched"]).astype(np.float32))
    np.testing.assert_array_equal(kf_t[o:], kf_j[o:])


def test_seed_members(jax_out, torch_out):
    m_t, m_j = _np(torch_out["seed_matched"]), jax_out["seed_matched"]
    assert (m_t != m_j).sum() <= 2 and m_j.sum() > 100
    assert abs(int(torch_out["n_seeds_updated"]) - int(jax_out["n_seeds_updated"])) <= 2
    both = m_t & m_j
    st, sj = torch_out["seeds"], jax_out["seeds"]
    np.testing.assert_allclose(_np(torch_out["seed_match_px"])[both],
                               jax_out["seed_match_px"][both], atol=2e-2)
    np.testing.assert_allclose(_np(st["mu"])[both], sj["mu"][both], atol=1e-3)
    np.testing.assert_allclose(_np(st["sigma2"])[both], sj["sigma2"][both], rtol=5e-3, atol=1e-6)
    np.testing.assert_allclose(_np(st["obs_uv"])[both], sj["obs_uv"][both], atol=5e-5)
    same = m_t == m_j
    for k in ("obs_count", "obs_valid", "b", "n_updates"):
        np.testing.assert_array_equal(_np(st[k])[same], sj[k][same], err_msg=k)
    for k in ("valid", "host", "px", "f", "level", "species", "grad", "a", "z_range",
              "converge_thresh", "batch_id", "host_win", "host_anchor", "temp_point"):
        np.testing.assert_array_equal(_np(st[k]), sj[k], err_msg=k)
    # rows the sweep did not match keep the estimate they came with
    mu_in = np.load(cs.BOOT_NPZ, allow_pickle=False)["seed_mu"]
    np.testing.assert_array_equal(_np(st["mu"])[~m_t], mu_in[~m_t])


def test_step_is_deterministic_and_leaves_its_inputs(world, torch_out):
    seeds_in = world["state"][8]
    before = {k: v.clone() for k, v in seeds_in.items()}
    again = _run_torch(world)
    for k in ("packed", "kf_pack", "T_new", "acc", "seed_match_px", "seed_matched"):
        assert torch.equal(again[k], torch_out[k]), k
    for k, v in again["seeds"].items():
        assert torch.equal(v, torch_out["seeds"][k]), k
    for k, v in before.items():
        assert torch.equal(seeds_in[k], v), k


def test_track_step_gives_the_same_pose_bits(world, torch_out):
    """The tracking half is the same body without the sweep."""
    half = _run_torch(world, whole=False)
    assert set(torch_out) - set(half) == set(SEED_KEYS)
    for k in ("T_new", "slot_pack", "acc", "px", "cid"):
        assert torch.equal(half[k], torch_out[k]), k
    assert float(half["packed"][19]) == 0.0
    keep = np.arange(24) != 19
    assert torch.equal(half["packed"][keep], torch_out["packed"][keep])


def test_snapshot_constants_and_scatter_rows():
    from hso_tpu.pipeline import fused_step as jfs

    assert fused_step.SNAP_HEAVY == jfs.SNAP_HEAVY and fused_step.SNAP_LIGHT == jfs.SNAP_LIGHT
    rs = np.random.RandomState(0)
    dst = rs.rand(12, 5).astype(np.float32)
    idx = np.array([3, 7, 7, 0], np.int32)
    src = rs.rand(4, 5).astype(np.float32)
    src[2] = src[1]                       # a padded index repeats a real row
    ref = np.asarray(jfs.scatter_rows(jnp.asarray(dst), jnp.asarray(idx), jnp.asarray(src)))
    d = torch.as_tensor(dst.copy())
    got = fused_step.scatter_rows(d, torch.as_tensor(idx), torch.as_tensor(src))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(d.numpy(), dst)       # the table passed in is left alone

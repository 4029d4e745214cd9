"""State carried across: ``track_state_from_checkpoint`` against the JAX
package's own chain on ``artifacts/bench_boot.npz`` (exact equality: it is
data movement), and the port's scene renderers against the JAX package's.
"""

import os

import numpy as np
import pytest
import torch

from hso_tpu.cameras import PinholeCamera as JaxPinhole
from hso_tpu.config import Config as JaxConfig
from hso_tpu.utils import synthetic as jax_synthetic
from hso_tpu_torch.cameras import PinholeCamera
from hso_tpu_torch.config import Config
from hso_tpu_torch.math import se3np
from hso_tpu_torch.utils import synthetic
from hso_tpu_torch.mapping.depth_filter import empty_seeds
from hso_tpu_torch.utils.checkpoint import (frame_state_from_checkpoint, prev_obs_from_numpy,
                                            seeds_from_numpy, seeds_to_numpy,
                                            snapshot_from_numpy, track_state_from_checkpoint)
from hso_tpu_torch.utils.evaluate import ate, umeyama

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOOT_NPZ = os.path.join(ROOT, "artifacts", "bench_boot.npz")


@pytest.mark.parametrize("patch_source", ["recency", "closest"])
def test_track_state_from_checkpoint_matches_jax_chain(patch_source):
    from hso_tpu.pipeline.frame_handler import FrameHandler
    from hso_tpu.utils.checkpoint import load_checkpoint

    cam_j = JaxPinhole(640, 480, 400.0, 400.0, 320.0, 240.0)
    vo = FrameHandler(cam_j, JaxConfig(patch_source=patch_source))
    load_checkpoint(vo, BOOT_NPZ, resume_stage="default")
    ref_snap = {k: np.asarray(v) for k, v in vo._snapshot().items()}
    last = vo.last_frame
    ref_obs = {k: np.asarray(v) for k, v in vo._prev_obs_dev(last).items()}

    cam = PinholeCamera(640, 480, 400.0, 400.0, 320.0, 240.0)
    (snap, prev_pyr, grad_mean, intensity, exposure, T_prev, prev_obs,
     frame_count) = track_state_from_checkpoint(BOOT_NPZ, cam, Config(patch_source=patch_source),
                                                device="cpu")
    assert set(snap) == set(ref_snap)
    for k, v in ref_snap.items():
        assert tuple(snap[k].shape) == v.shape, k
        np.testing.assert_array_equal(snap[k].numpy(), v, err_msg=k)
    assert snap["light"].dtype == torch.int32 and snap["species"].dtype == torch.int32
    assert snap["pt_pack"].shape == (4096, 588) and snap["pt_pack"].dtype == torch.float32
    for k, v in ref_obs.items():
        np.testing.assert_array_equal(prev_obs[k].numpy(), v, err_msg=k)
    assert prev_obs["valid"].dtype == torch.bool and prev_obs["pid"].dtype == torch.int32
    assert len(prev_pyr) == len(last.data["pyr"]) == 5
    for a, b in zip(prev_pyr, last.data["pyr"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (grad_mean, intensity, exposure) == (last.grad_mean, last.intensity_mean,
                                                last.exposure)
    np.testing.assert_array_equal(T_prev.numpy(), last.T_f_w.astype(np.float32))
    assert frame_count == vo.frame_count == 55


def test_frame_state_from_checkpoint_matches_jax_loader():
    """The seed table and the depth filter's bookkeeping against the JAX
    loader's; the tracking members are ``track_state_from_checkpoint``'s."""
    from hso_tpu.pipeline.frame_handler import FrameHandler
    from hso_tpu.utils.checkpoint import load_checkpoint

    vo = FrameHandler(JaxPinhole(640, 480, 400.0, 400.0, 320.0, 240.0), JaxConfig())
    load_checkpoint(vo, BOOT_NPZ, resume_stage="default")
    ref_seeds = {k: np.asarray(v) for k, v in vo.seeds.items()}

    cam = PinholeCamera(640, 480, 400.0, 400.0, 320.0, 240.0)
    state = frame_state_from_checkpoint(BOOT_NPZ, cam, Config(), device="cpu")
    track = track_state_from_checkpoint(BOOT_NPZ, cam, Config(), device="cpu")
    assert len(state) == len(track) + 4
    for a, b in zip(state[1], track[1]):
        assert torch.equal(a, b)
    assert torch.equal(state[5], track[5]) and state[7] == track[7] == 55
    for k in track[0]:
        assert torch.equal(state[0][k], track[0][k]), k
    seeds, seed_ring, batch_counter, px_error_angle = state[8:]
    # the JAX loader takes every ``seed_*`` key, so ``seed_ring`` lands in its
    # seed dict as "ring"; the port's table has the members of empty_seeds only
    assert set(ref_seeds) - set(seeds) == {"ring"} and "ring" not in seeds
    proto = empty_seeds(1024, "cpu")
    assert set(seeds) == set(proto)
    for k, v in seeds.items():
        assert v.dtype == proto[k].dtype and v.shape == proto[k].shape, k
        assert v.numpy().dtype == ref_seeds[k].dtype, k
        np.testing.assert_array_equal(v.numpy(), ref_seeds[k], err_msg=k)
    assert int(seeds["valid"].sum()) == 151
    np.testing.assert_array_equal(seed_ring, vo.seed_ring)
    assert seed_ring.dtype == np.int32 and list(seed_ring) == [-1, 1, 2, 3, 4, 5, -1, -1]
    assert batch_counter == vo.batch_counter == 5
    assert px_error_angle == vo.px_error_angle


def test_seed_table_round_trip():
    z = np.load(BOOT_NPZ, allow_pickle=False)
    d = {k[len("seed_"):]: z[k] for k in z.files if k.startswith("seed_")}
    assert "ring" in d
    seeds = seeds_from_numpy(d, "cpu")
    back = seeds_to_numpy(seeds)
    assert "ring" not in back and set(back) == set(d) - {"ring"}
    for k, v in back.items():
        assert v.dtype == d[k].dtype, k
        np.testing.assert_array_equal(v, d[k], err_msg=k)
    # types are forced to the table's own, whatever the arrays arrive as
    d64 = {k: (v.astype(np.float64) if v.dtype == np.float32 else v.astype(np.int64)
               if v.dtype == np.int32 else v) for k, v in d.items()}
    again = seeds_from_numpy(d64, "cpu")
    for k, v in again.items():
        assert v.dtype == seeds[k].dtype and torch.equal(v, seeds[k]), k
    with pytest.raises(KeyError):
        seeds_from_numpy({k: v for k, v in d.items() if k != "mu"}, "cpu")
    with pytest.raises(ValueError):
        seeds_from_numpy(dict(d, mu=d["mu"][:10]), "cpu")


def test_snapshot_from_numpy_types_and_unknown_key():
    snap = snapshot_from_numpy({"pos_w": np.zeros((4, 3), np.float64),
                                "light": np.arange(4, dtype=np.int64)}, "cpu")
    assert snap["pos_w"].dtype == torch.float32 and snap["light"].dtype == torch.int32
    with pytest.raises(KeyError):
        snapshot_from_numpy({"seeds": np.zeros(3)}, "cpu")
    obs = prev_obs_from_numpy({"px": np.zeros((2, 2)), "f": np.zeros((2, 3)),
                               "pid": np.array([1, 2]), "valid": np.array([1, 0])}, "cpu")
    assert obs["pid"].dtype == torch.int32 and obs["valid"].dtype == torch.bool


SCENES = {
    "box": (lambda m, cam: m.BoxScene(cam, half_width=2.0, half_height=1.5, depth=4.5, seed=3,
                                      stepped_back=True, tex_size=1024)),
    "plane": (lambda m, cam: m.PlaneScene(cam, z0=2.0, extent=2.5, seed=3, tex_size=1024)),
}


@pytest.mark.parametrize("kind", sorted(SCENES))
def test_scene_renders_match_jax_package(kind):
    """The port blurs its textures with scipy instead of OpenCV: rendered
    uint8 frames are at most 1 grey level apart on at most 0.1 % of pixels."""
    cam_j = JaxPinhole(320, 240, 200.0, 200.0, 160.0, 120.0)
    cam_t = PinholeCamera(320, 240, 200.0, 200.0, 160.0, 120.0)
    ref_scene = SCENES[kind](jax_synthetic, cam_j)
    scene = SCENES[kind](synthetic, cam_t)
    for xi in ([0.0] * 6, [0.3, 0.05, 0.03, 0.01, -0.03, 0.01]):
        T = se3np.exp(np.array(xi))
        a = ref_scene.render(T).astype(np.int32)
        b = scene.render(T).astype(np.int32)
        d = np.abs(a - b)
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())
    px = np.array([[40.0, 50.0], [160.0, 120.0], [300.0, 200.0]])
    np.testing.assert_allclose(scene.depth_along_ray(px, T), ref_scene.depth_along_ray(px, T),
                               rtol=1e-12)
    if kind == "plane":
        for a, b in zip(scene.grid_features(step=40, border=40),
                        ref_scene.grid_features(step=40, border=40)):
            np.testing.assert_allclose(a, b, rtol=1e-12)


def test_evaluate_matches_jax_package():
    from hso_tpu.utils import evaluate as jax_evaluate

    rs = np.random.RandomState(0)
    gt = rs.normal(size=(30, 3))
    R = se3np.so3_exp(np.array([0.2, -0.1, 0.3]))
    est = (gt @ R.T) * 0.5 + np.array([1.0, 2.0, 3.0]) + rs.normal(0, 1e-3, gt.shape)
    for a, b in zip(umeyama(est, gt), jax_evaluate.umeyama(est, gt)):
        np.testing.assert_allclose(a, b)
    r, r_ref = ate(est, gt), jax_evaluate.ate(est, gt)
    assert r.rmse == r_ref.rmse and r.n_pairs == 30
    assert abs(r.scale - 2.0) < 1e-2 and r.rmse < 5e-3

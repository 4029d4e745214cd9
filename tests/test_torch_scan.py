"""The whole slice: the port's evolving-map scan (``run_scan``) against the
JAX package's scan (``bench.py:365-553``, kept line for line in
``tests/scan_reference_jax.py``) on the CPU, over 7 frames from
``artifacts/bench_boot.npz``: five frames, the keyframe event on the sixth
(``i % 6 == 5``), then one frame that tracks against the map the event
changed and sweeps the seeds it created.

Both sides render the same frames (the port's box scene along the
benchmark's trajectory).  Tolerances: ``T_new`` to 1e-5 up to the event (the
whole step alone agrees to 1e-6, ``tests/test_torch_frame_step.py``) and 1e-4
after it, where the map carries the BA's float32 write-back (poses 1e-5,
inverse distances 1e-4 relative, ``tests/test_torch_keyframe.py``).  Cell
selection and the inlier masks are integer work: the same on every frame.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from hso_tpu_torch.bench import scan_ate
from hso_tpu_torch.config import Config
from hso_tpu_torch.pipeline import scan
from hso_tpu_torch.utils.checkpoint import scan_state_from_checkpoint
from scan_reference_jax import JaxScan

torch.set_num_threads(1)

N = 7


@pytest.fixture(scope="module")
def world():
    cam, cfg = cs.bench_camera(), Config()
    carry, meta = scan_state_from_checkpoint(cs.BOOT_NPZ, cam, cfg, "cpu")
    fc = meta["frame_count"]
    poses = cs.trajectory(fc + N)[fc:]
    scene = cs.bench_scene(cam)
    frames = [scene.render(T) for T in poses]
    return dict(cam=cam, cfg=cfg, carry=carry, meta=meta, frames=frames, poses=poses)


@pytest.fixture(scope="module")
def port(world):
    outs = []
    step = scan.make_scan_step(world["cam"], world["cfg"], "cpu")

    def keep(i, kf, out, carry):
        outs.append({k: out[k].numpy() for k in ("T_new", "cid", "inlier", "success")})

    res = scan.run_scan(step, world["carry"], world["frames"], world["cam"], world["cfg"],
                        world["meta"]["px_error_angle"], on_frame=keep)
    return res, outs


@pytest.fixture(scope="module")
def ref(world):
    return JaxScan(cs.BOOT_NPZ).run(world["frames"])


def test_schedule_has_one_keyframe_event(port):
    res, _ = port
    assert [scan.is_keyframe(i) for i in range(N)] == [False] * 5 + [True, False]
    assert len(res["kf_stats"]) == 1
    st = res["carry"]["st"]
    for k, n in (("kf_count", 7), ("batch", 6)):
        assert st[k].dtype == torch.int32 and st[k].shape == (), k     # device scalars
        assert int(st[k]) == n, k


def test_poses_before_and_after_the_event(port, ref):
    res, _ = port
    traj_j = ref[0]
    traj_t = res["traj"].numpy()
    np.testing.assert_allclose(traj_t[:6], traj_j[:6], atol=1e-5)
    np.testing.assert_allclose(traj_t[6:], traj_j[6:], atol=1e-4)


def test_selection_and_inliers_every_frame(port, ref):
    _, outs_t = port
    outs_j = ref[2]
    for i, (a, b) in enumerate(zip(outs_t, outs_j)):
        for k in ("cid", "success", "inlier"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"frame {i}: {k}")
    n_inl = port[0]["n_inliers"].numpy()
    np.testing.assert_array_equal(n_inl, [int(o["n_inliers"]) for o in outs_j])
    assert n_inl.min() >= 50


def test_check_sum_and_tracking(world, port, ref):
    res, _ = port
    np.testing.assert_allclose(float(res["chk"]), ref[1].sum(), rtol=1e-4)
    assert scan_ate(res["traj"].numpy(), world["poses"]) < 0.01


def test_start_state_is_left_untouched(world, port):
    carry = world["carry"]
    again, _ = scan_state_from_checkpoint(cs.BOOT_NPZ, world["cam"], world["cfg"], "cpu")
    for k, v in again["st"].items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(carry["st"][k], v), k
        else:
            assert carry["st"][k] == v, k
    for k, v in again["seeds"].items():
        assert torch.equal(carry["seeds"][k], v), k

"""Checkpoints both ways: the JAX package's ``save_checkpoint`` → the port's
``load_checkpoint`` → the port's ``save_checkpoint`` → the JAX package's
``load_checkpoint``, starting from ``artifacts/bench_boot.npz``.  The two
files hold the same members with the same arrays, and the state each side
restores is the other's."""

import numpy as np
import pytest
import torch

from hso_tpu.cameras import PinholeCamera as JaxCamera
from hso_tpu.config import Config as JaxConfig
from hso_tpu.pipeline.frame_handler import FrameHandler as JaxHandler
from hso_tpu.utils.checkpoint import load_checkpoint as jax_load, save_checkpoint as jax_save
from hso_tpu_torch.bench import BOOT_NPZ, bench_camera
from hso_tpu_torch.config import Config
from hso_tpu_torch.pipeline.frame_handler import STAGE_DEFAULT, STAGE_RELOC, FrameHandler
from hso_tpu_torch.utils.checkpoint import PT_SAVED, load_checkpoint, save_checkpoint

torch.set_num_threads(1)


def jax_handler():
    return JaxHandler(JaxCamera(640, 480, 400.0, 400.0, 320.0, 240.0), JaxConfig())


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    a, b = str(d / "jax.npz"), str(d / "port.npz")
    hj = jax_handler()
    jax_load(hj, BOOT_NPZ, resume_stage="default")
    jax_save(hj, a)
    ht = FrameHandler(bench_camera(), Config(), device="cpu")
    load_checkpoint(ht, a, resume_stage="default")
    save_checkpoint(ht, b)
    hj2 = jax_handler()
    jax_load(hj2, b, resume_stage="default")
    return dict(a=a, b=b, hj=hj, ht=ht, hj2=hj2)


def test_files_hold_the_same_arrays(files):
    za, zb = np.load(files["a"]), np.load(files["b"])
    assert set(za.files) == set(zb.files)
    for k in za.files:
        assert za[k].dtype == zb[k].dtype and np.array_equal(za[k], zb[k]), k


def test_port_restores_the_jax_state(files):
    hj, ht = files["hj"], files["ht"]
    for k in PT_SAVED:
        assert np.array_equal(getattr(hj.points, k), getattr(ht.points, k)), k
    assert hj.points._free == ht.points._free
    # the inverted index: the JAX lists against the port's table (as loaded,
    # every registered cell is live)
    kf, i = np.nonzero(ht.kfs.reg_pid[:len(ht.kfs.frames)] >= 0)
    pid = ht.kfs.reg_pid[kf, i]
    assert hj.points.obs_refs == [list(zip(kf[pid == p].tolist(), i[pid == p].tolist()))
                                  for p in range(ht.points.p_max)]
    assert ht.kfs.live().sum() == len(kf)
    assert np.array_equal(hj.kfs.poses, ht.kfs.poses)
    assert len(hj.kfs.frames) == len(ht.kfs.frames) == 6
    for a, b in zip(hj.kfs.frames, ht.kfs.frames):
        assert np.array_equal(a.T_f_w, b.T_f_w) and a.timestamp == b.timestamp
        assert all(np.array_equal(a.obs[k], b.obs[k]) for k in a.obs)
    last_j, last_t = hj.kfs.frames[-1], ht.kfs.frames[-1]
    assert [f.data is None for f in ht.kfs.frames] == [True] * 5 + [False]
    assert all(np.array_equal(np.asarray(x), y.numpy())
               for x, y in zip(last_j.data["pyr"], last_t.data["pyr"]))
    assert (last_j.grad_mean, last_j.intensity_mean, last_j.exposure) == \
        (last_t.grad_mean, last_t.intensity_mean, last_t.exposure)
    for k, v in ht.seeds.items():
        assert np.array_equal(np.asarray(hj.seeds[k]), v.numpy()), k
    assert (hj.batch_counter, hj.frame_count, hj.mean_converge_frames) == \
        (ht.batch_counter, ht.frame_count, ht.mean_converge_frames)
    assert np.array_equal(hj.seed_ring, ht.seed_ring)
    assert np.array_equal(hj.motion_model, ht.motion_model)
    assert ht.stage == STAGE_DEFAULT and ht.last_frame is ht.kfs.frames[-1]


def test_jax_restores_the_port_file(files):
    hj, hj2 = files["hj"], files["hj2"]
    for k in PT_SAVED:
        assert np.array_equal(getattr(hj.points, k), getattr(hj2.points, k)), k
    for k in hj2.seeds:
        assert np.array_equal(np.asarray(hj.seeds[k]), np.asarray(hj2.seeds[k])), k
    assert hj2.stage == hj.stage and hj2.frame_count == hj.frame_count


def test_resume_without_a_stage_relocalizes(files):
    ht = FrameHandler(bench_camera(), Config(), device="cpu")
    load_checkpoint(ht, files["b"])
    assert ht.stage == STAGE_RELOC and int(ht.points.valid.sum()) == 483


@pytest.mark.parametrize("side", ["jax", "port"])
def test_saved_seed_ring_is_the_handlers(side, tmp_path):
    """A keyframe event after a resume writes its slot of the seed-host ring.
    The JAX package's loader takes the file's ``seed_ring`` into the seed
    table too (``seed_`` prefix: ``seeds["ring"]``), and its writer then saves
    that stale copy over the handler's ring; the port's seed table holds only
    its members, so the port saves the ring the handler has."""
    if side == "jax":
        h = jax_handler()
        jax_load(h, BOOT_NPZ, resume_stage="default")
        assert "ring" in h.seeds
    else:
        h = FrameHandler(bench_camera(), Config(), device="cpu")
        load_checkpoint(h, BOOT_NPZ, resume_stage="default")
        assert "ring" not in h.seeds
    old = h.seed_ring.copy()
    h.seed_ring[6] = 6                       # what the next keyframe event writes
    path = str(tmp_path / "ring.npz")
    (jax_save if side == "jax" else save_checkpoint)(h, path)
    saved = np.load(path)["seed_ring"]
    assert np.array_equal(saved, old if side == "jax" else h.seed_ring)

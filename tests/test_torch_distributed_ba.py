"""The port's point-sharded BA over ``torch.distributed``
(``hso_tpu_torch.ba.distributed``) on the CPU, against the JAX package's
``hso_tpu.ba.distributed`` and the port's single-device solver.

* ``shard_problem`` pads as the JAX one does, to the bit.
* One rank (no process group): the drop-in gives the port's
  ``local_bundle_adjustment`` result bit for bit (the same sums in the same
  order), and the handler with ``distributed_ba=True`` tracks the resumed
  bench trajectory through its first keyframe event exactly as with False.
* 2 and 4 gloo ranks (``python -m hso_tpu_torch.tools.multiproc_ba``, a
  ``FileStore`` in ``tmp_path``, each run with its own time limit) on
  ``artifacts/bench_ba.npz`` (K 16, P 2,048): held to the JAX drop-in on the 8
  virtual CPU devices and to the port's local solver with the JAX tests'
  tolerances (chi2 rtol 0.1 / atol 1e-5, inverse distances rtol 0.05 / atol
  1e-3, inlier agreement above 0.98, ``tests/test_distributed_ba.py``); each
  rank solves twice and requires the same bits, and every rank holds rank
  0's poses.
* More point blocks than ranks raises.
"""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hso_tpu.ba import distributed as jd
from hso_tpu_torch import testing
from hso_tpu_torch.ba import distributed as td
from hso_tpu_torch.ba.local_ba import local_bundle_adjustment
from hso_tpu_torch.tools.multiproc_ba import BA_NPZ, TOL, load_ba_problem

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 240


@functools.lru_cache(maxsize=None)
def captured():
    args, kw = load_ba_problem(BA_NPZ, "cpu")
    return args, kw, local_bundle_adjustment(*args, **kw)


@functools.lru_cache(maxsize=None)
def jax_distributed():
    args, kw, _ = captured()
    T, free, idist, pv, obs = (a.numpy() if isinstance(a, torch.Tensor) else a for a in args)
    out = jd.distributed_bundle_adjustment(
        jnp.asarray(T), jnp.asarray(free), jnp.asarray(idist), jnp.asarray(pv),
        {k: jnp.asarray(v.numpy()) for k, v in obs.items()}, n_devices=8, **kw)
    return {k: np.asarray(out[k]) for k in ("T_kf", "idist", "obs_inlier", "chi2_final")}


def hold(got: dict, ref: dict, pvalid: np.ndarray) -> None:
    np.testing.assert_allclose(float(got["chi2_final"]), float(ref["chi2_final"]),
                               rtol=TOL["chi2_rtol"], atol=TOL["chi2_atol"])
    np.testing.assert_allclose(np.asarray(got["idist"])[pvalid], np.asarray(ref["idist"])[pvalid],
                               rtol=TOL["idist_rtol"], atol=TOL["idist_atol"])
    agree = np.asarray(got["obs_inlier"]) == np.asarray(ref["obs_inlier"])
    assert agree.mean() > TOL["inlier_agreement"]


def test_shard_problem_equals_jax():
    prob = testing.ba_problem(seed=4, noise_px=0.1)
    for n_dev in (1, 3, 8):
        oj, ij, pj, lj = jd.shard_problem(prob["obs"], prob["idist"], prob["point_valid"], n_dev)
        ot, it, pt, lt = td.shard_problem(prob["obs"], prob["idist"], prob["point_valid"], n_dev)
        assert lt == lj
        np.testing.assert_array_equal(it.numpy(), ij)
        np.testing.assert_array_equal(pt.numpy(), pj)
        assert sorted(ot) == sorted(oj)
        for k in oj:
            np.testing.assert_array_equal(ot[k].numpy(), oj[k])


def test_one_rank_is_the_local_solver():
    args, kw, ref = captured()
    out = td.distributed_bundle_adjustment(*args, **kw)
    for k in ("T_kf", "idist", "obs_inlier", "chi2_init", "chi2_final"):
        assert torch.equal(out[k], ref[k]), k
    hold({k: v.numpy() for k, v in out.items() if k != "deltas"}, jax_distributed(),
         args[3].numpy())


def test_more_blocks_than_ranks_raises():
    args, kw, _ = captured()
    with pytest.raises(ValueError, match="2 point blocks"):
        td.distributed_bundle_adjustment(*args, n_devices=2, **kw)


def run_ranks(tmp_path, world: int) -> dict:
    store = tmp_path / "store"
    out = tmp_path / "rank0"
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-m", "hso_tpu_torch.tools.multiproc_ba",
                               "--rank", str(r), "--world", str(world),
                               "--init", f"file://{store}", "--device", "cpu",
                               "--out", str(out)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-3000:]
    doc = json.loads((tmp_path / "rank0.json").read_text())
    z = np.load(tmp_path / "rank0.npz")
    return doc, {k: z[k] for k in z.files}


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_ranks_hold_to_jax_and_to_the_local_solver(tmp_path, world):
    doc, got = run_ranks(tmp_path, world)
    assert doc["ok"] and doc["world"] == world and doc["bitwise_repeat"]
    assert doc["p_local"] == -(-2048 // world)
    args, _, ref = captured()
    pv = args[3].numpy()
    hold(got, jax_distributed(), pv)
    hold(got, {k: v.numpy() for k, v in ref.items() if k != "deltas"}, pv)
    assert np.abs(got["T_kf"] - ref["T_kf"].numpy()).max() < 5e-3


def test_rank_tool_refuses_to_run_without_a_card(tmp_path):
    """``python -m hso_tpu_torch.tools.multiproc_ba`` runs on the card unless
    asked for the CPU; without a card it says so and exits 2."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, "-m", "hso_tpu_torch.tools.multiproc_ba", "--rank",
                          "0", "--world", "1", "--init", f"file://{tmp_path}/store"], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
                         timeout=RANK_TIMEOUT_S)
    assert res.returncode == 2 and res.stdout == "" and "--device cpu" in res.stderr


def test_handler_with_distributed_ba_on_one_rank():
    from hso_tpu_torch.bench import BOOT_NPZ, bench_camera, bench_scene, trajectory
    from hso_tpu_torch.config import Config
    from hso_tpu_torch.pipeline import ba_glue
    from hso_tpu_torch.pipeline.frame_handler import RESULT_KEYFRAME, FrameHandler
    from hso_tpu_torch.utils.checkpoint import load_checkpoint

    cam = bench_camera()
    scene = bench_scene(cam)

    def run(flag):
        vo = FrameHandler(cam, Config(distributed_ba=flag), device="cpu")
        load_checkpoint(vo, BOOT_NPZ, resume_stage="default")
        start = vo.frame_count
        statuses = []
        for k, T in enumerate(trajectory(start + 6)[start:]):
            statuses.append(vo.add_image(scene.render(T), ts=float(start + k)).status)
        return statuses, vo

    calls = {"dist": 0}
    orig = ba_glue.distributed_bundle_adjustment

    def counting(*a, **k):
        calls["dist"] += 1
        return orig(*a, **k)

    ba_glue.distributed_bundle_adjustment = counting
    try:
        s_off, h_off = run(False)
        assert calls["dist"] == 0
        s_on, h_on = run(True)
    finally:
        ba_glue.distributed_bundle_adjustment = orig
    assert RESULT_KEYFRAME in s_on and calls["dist"] >= 1, (s_on, calls)
    assert s_on == s_off
    for (ta, Ta), (tb, Tb) in zip(h_on.trajectory, h_off.trajectory):
        assert ta == tb and np.array_equal(Ta, Tb)
    np.testing.assert_array_equal(h_on.points.idist, h_off.points.idist)

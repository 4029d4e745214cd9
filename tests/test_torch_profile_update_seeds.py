"""The sweep bisection (``hso_tpu_torch.tools.profile_update_seeds``) on the
CPU.

* Stage 6 of the prefix chain (the stages of ``depth_filter.SWEEP_STAGES``,
  the functions ``update_seeds`` runs) gives ``update_seeds``' matched pixels
  and triangulated depths bit for bit: on the profiler's own inputs, and on
  the checkpoint's seed table swept against a rendered frame at the
  checkpoint's last pose (where seeds do match).
* On the profiler's input recipe at S = 64 the port's ``update_seeds`` holds
  to the JAX package's on the same numpy inputs, with the tolerances of
  ``tests/test_torch_depth_filter.py``: visibility, matches and the ``b``
  counter exact; matched pixels to 2e-2 (the alignment's 5e-3 px at its
  search level, in level-0 pixels), ``mu`` to 1e-3 and ``sigma2`` to 1e-4 on
  rows both sides matched.
* The rows run on the CPU at a small size, and the tool refuses to run without
  a card unless asked for the CPU.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hso_tpu.cameras import PinholeCamera as JaxPinhole
from hso_tpu.mapping import depth_filter as jdf
from hso_tpu_torch.tools import profile_update_seeds as pus
from hso_tpu_torch.utils.checkpoint import seeds_to_numpy

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def test_inputs_follow_the_jax_recipe():
    """The draws of the JAX script, in its order (rng checked by its last draw
    of each kind), at two sizes."""
    for s in (64, 1536):
        inp = pus.sweep_inputs(s, 2)
        rng = np.random.default_rng(0)
        levels = [rng.standard_normal((480 >> lv, 640 >> lv)) * 40 + 120 for lv in (1, 2)]
        px = np.c_[rng.uniform(40, 600, s), rng.uniform(40, 440, s)]
        np.testing.assert_array_equal(inp["pyr12"][1], levels[1].astype(np.float32))
        np.testing.assert_array_equal(inp["px"], px.astype(np.float32))
        assert inp["imgs"].shape == (2, 480, 640) and inp["host_win"].shape == (s, 44, 44)
        f = inp["f"]
        np.testing.assert_allclose(np.linalg.norm(f, axis=-1), 1.0, atol=1e-6)


def test_stage6_equals_update_seeds_on_the_recipe():
    sw = pus.Sweep(pus.sweep_inputs(256, 1), CPU)
    got = sw.stage6_check()
    assert got["px_bitwise"] and got["z_meas_bitwise"] and got["matched_within_meas_ok"]
    t = got["tensors"]
    assert torch.equal(t["px"], t["px_match"]) and torch.equal(t["z_meas"], t["z_whole"])


def test_stage6_equals_update_seeds_where_seeds_match():
    """The checkpoint's seed table (151 live of 1,024) swept against the next
    frame of the bench trajectory at the checkpoint's last pose (the map's own
    frame and scale): seeds match, and stage 6 still gives ``update_seeds``'
    pixels and depths bit for bit."""
    from hso_tpu_torch.bench import BOOT_NPZ, bench_camera, bench_scene, trajectory
    from hso_tpu_torch.config import Config
    from hso_tpu_torch.image.pyramid import build_frame_pyramids
    from hso_tpu_torch.utils import checkpoint

    cam, cfg = bench_camera(), Config()
    st = checkpoint.frame_state_from_checkpoint(BOOT_NPZ, cam, cfg, CPU)
    snap, exposure, T_prev, frame_count, seeds, px_err = (st[i] for i in (0, 4, 5, 7, 8, 11))
    img = bench_scene(cam).render(trajectory(frame_count + 1)[frame_count])
    pyr = build_frame_pyramids(img, device=CPU)["pyr"]
    got = pus.stage6_vs_update_seeds(seeds, snap["ring_T"], snap["ring_exp"], pyr, T_prev,
                                     exposure, px_err, cam)
    assert got["n_matched"] > 30, got["n_matched"]
    assert got["px_bitwise"] and got["z_meas_bitwise"] and got["matched_within_meas_ok"]
    z = got["tensors"]["z_meas"]
    assert bool((z > 0).sum() >= got["n_matched"])


def test_update_seeds_holds_to_jax_on_the_recipe():
    inp = pus.sweep_inputs(64, 1)
    sw = pus.Sweep(inp, CPU)
    pyr = (sw.imgs[0],) + sw.pyr12
    out_t, st_t = pus.depth_filter.update_seeds(
        dict(sw.seeds), sw.ring_T, sw.ring_exp, pyr, None, None, sw.T_cur, 1.0,
        pus.px_error_angle(sw.cam), sw.cam)
    got = seeds_to_numpy(out_t)
    seeds_np = seeds_to_numpy(sw.seeds)
    out_j, st_j = jdf.update_seeds(
        {k: jnp.asarray(v) for k, v in seeds_np.items()}, jnp.asarray(sw.ring_T.numpy()),
        jnp.asarray(sw.ring_exp.numpy()), tuple(jnp.asarray(p.numpy()) for p in pyr), None, None,
        jnp.asarray(inp["T_cur"]), 1.0, pus.px_error_angle(sw.cam), JaxPinhole(640, 480, 400.0, 400.0,
                                                                       320.0, 240.0))
    ref = {k: np.asarray(v) for k, v in out_j.items()}
    assert int(st_t["n_visible"]) == int(st_j["n_visible"]) > 0
    matched_t, matched_j = st_t["matched"].numpy(), np.asarray(st_j["matched"])
    np.testing.assert_array_equal(matched_t, matched_j)
    np.testing.assert_array_equal(got["b"], ref["b"])
    np.testing.assert_array_equal(got["obs_count"], ref["obs_count"])
    both = matched_t & matched_j
    np.testing.assert_allclose(st_t["px_match"].numpy()[both], np.asarray(st_j["px_match"])[both],
                               atol=2e-2)
    np.testing.assert_allclose(got["mu"][both], ref["mu"][both], atol=1e-3)
    np.testing.assert_allclose(got["sigma2"][both], ref["sigma2"][both], atol=1e-4)
    np.testing.assert_array_equal(got["mu"][~both], ref["mu"][~both])


def test_rows_on_the_cpu():
    doc = pus.profile(s=64, n=2, reps=1, device="cpu")
    assert [r["row"] for r in doc["rows"]] == [label for label, _ in pus.ROWS]
    assert doc["rows"][4]["row"] == "4 (removed)"
    for row in doc["rows"]:
        assert row["eager_ms_per_frame"] > 0
        assert row["device_ms_per_frame"].startswith("not measured")
        assert "eager_ms_marginal" in row
    lines = pus.text_lines(doc)
    assert len(lines) == len(pus.ROWS) and "ms/frame  (marginal" in lines[0]


def test_fold_is_finite_and_reads_every_tensor():
    a = torch.tensor([1.0, float("inf")])
    assert float(pus.fold({"a": torch.ones(3), "b": (torch.ones(2, dtype=torch.int32),
                                                   torch.tensor([True, False]))})) == 6.0
    assert torch.isfinite(pus.fold([a]))


def test_tool_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, "-m", "hso_tpu_torch.tools.profile_update_seeds"],
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 2 and res.stdout == "" and "cpu=1" in res.stderr


def test_kernel_bounds_count_as_the_kernel_lines_do():
    """At the step's own table size the bounds are the kernel table's S = 1,024
    rows (``chip_smoke.py``'s counts: K2 0.00392 ms, K4 0.00210, K6 0.00294),
    and they grow with the rows."""
    b = pus.kernel_bounds_ms(1024)
    assert round(b["pack_level_windows"], 5) == 0.00392
    assert round(b["align_match"], 5) == 0.00210
    assert round(b["zmncc_line_scores"], 5) == 0.00294
    small, big = pus.kernel_bounds_ms(151), pus.kernel_bounds_ms(1536)
    assert all(small[k] < b[k] < big[k] for k in b)

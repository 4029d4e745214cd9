"""The weak-scaling harness of the point-sharded BA
(``hso_tpu_torch.tools.bench_distributed_ba``) on the CPU.

* Its problem, the port's ``testing.ba_problem(…, seed=7)``, is the JAX
  harness's ``tests/test_local_ba.py::make_ba_problem`` on the same
  arguments, array for array (both are numpy).
* 1 and 2 gloo ranks at ``pts_per_dev=32``, ``kf=4``, ``iters=2``: every line
  has the JAX harness's keys; each solution holds to the local solver with the
  tolerances of ``tests/test_torch_distributed_ba.py`` (chi2 rtol 0.1 / atol
  1e-5, inverse distances rtol 0.05 / atol 1e-3, inlier agreement above 0.98,
  poses 5e-3) and repeats bit for bit; the payload counted per LM iteration is
  what the shapes of ``_reduce``'s two reductions give for K = 4; the
  projection holds no TPU constant.
* The tool refuses to run without a card unless asked for the CPU.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hso_tpu_torch import testing
from hso_tpu_torch.tools import bench_distributed_ba as bdb
from hso_tpu_torch.tools.multiproc_ba import TOL
from test_local_ba import make_ba_problem

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROW_KEYS = ("devices", "pts_total", "pts_per_dev", "obs_total", "step_ms",
                "step_ms_1dev_same_problem", "overhead_efficiency", "chi2")


@pytest.mark.parametrize("kf,pts", [(4, 32), (4, 64), (12, 640)])
def test_problem_is_the_jax_harness_problem(kf, pts):
    a = testing.ba_problem(n_kf=kf, n_pts=pts, K=kf, P=pts, noise_px=0.3, seed=7)
    b = make_ba_problem(n_kf=kf, n_pts=pts, K=kf, P=pts, noise_px=0.3, seed=7)
    # the JAX maker also returns the unpadded host slots and bearings, which the
    # port's keeps only inside ``obs``
    assert sorted(b) == sorted(list(a) + ["f_host", "host"])
    np.testing.assert_array_equal(a["obs"]["host"][:pts], b["host"])
    np.testing.assert_array_equal(a["obs"]["f_host"][:pts], b["f_host"].astype(np.float32))
    for k in a:
        if k == "obs":
            assert sorted(a[k]) == sorted(b[k])
            for name in a[k]:
                np.testing.assert_array_equal(a[k][name], np.asarray(b[k][name]), err_msg=name)
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.fixture(scope="module")
def small_run():
    lines = []
    doc = bdb.weak_scaling("cpu", (1, 2), pts_per_dev=32, n_kf=4, n_iter=2, reps=2,
                           emit=lines.append)
    return doc, lines


def test_rows_have_the_jax_keys_and_hold_to_the_local_solver(small_run):
    doc, lines = small_run
    rows = doc["results"]
    assert [r["devices"] for r in rows] == [1, 2]
    for row in rows:
        assert all(k in row for k in JAX_ROW_KEYS + ("weak_scaling_efficiency",))
        assert row["pts_per_dev"] == 32 and row["pts_total"] == 32 * row["devices"]
        assert row["agrees_with_local_solver"] and row["bitwise_second_run"]
        v = row["vs_local_solver"]
        assert abs(v["chi2_final"] - v["chi2_final_local"]) <= \
            TOL["chi2_rtol"] * abs(v["chi2_final_local"]) + TOL["chi2_atol"]
        assert v["idist_max_abs"] <= TOL["idist_atol"] and v["T_max_abs"] < 5e-3
        assert v["inlier_agreement"] > TOL["inlier_agreement"]
        assert np.isfinite(row["chi2"]) and row["step_ms"] > 0
    assert rows[0]["weak_scaling_efficiency"] == 1.0
    assert sum("metric" in line for line in lines) == 2


def test_counted_payload_is_what_the_shapes_give(small_run):
    doc, _ = small_run
    inv = doc["collectives_measured"]
    c = 6 * 4                                    # the camera system of K = 4
    schur = 4 * (c * c + c)                      # Wᵀ·H_pp⁻¹·W and Wᵀ·H_pp⁻¹·g_p
    build = 4 * (c * c + c + 1)                  # H_cc, g_c and chi2
    assert inv["payload_bytes_per_lm_iteration"] == schur + build
    assert inv["collectives_per_lm_iteration"] == 2
    assert inv["payload_bytes_per_solve"] == 2 * (schur + build) + build
    kinds = {(k["op"], k["where"], k["issued_by"]): k for k in inv["collectives"]}
    assert kinds[("all_reduce", "initial_build", "build")]["count"] == 1
    assert kinds[("all_reduce", "lm_loop", "schur_solve")]["count"] == 2
    assert kinds[("all_reduce", "lm_loop", "build")]["shapes"] == [[c, c], [c], []]
    gather = [k for k in inv["collectives"] if k["op"] == "all_gather"]
    assert len(gather) == 1 and gather[0]["shapes"] == [[32, 1 + 4]]


def test_projection_holds_no_tpu_constant(small_run):
    doc, _ = small_run
    proj = doc["projection"]
    text = json.dumps(proj)
    assert "TPU" not in text and "ICI" not in text and "v5e" not in text
    assert proj["link_bytes_per_s"] == bdb.NVLINK_BYTES_PER_S != 4.0e10
    assert proj["collective_latency_s"] != 5.0e-6
    assert proj["anchor_solve_ms"] == doc["results"][0]["step_ms_1dev_same_problem"]
    assert "not a device figure" in proj["anchor_source"]
    effs = proj["projected_efficiency_by_devices"]
    assert sorted(effs, key=int) == ["2", "4", "8", "16", "32"]
    assert all(0.0 < e <= 1.0 for e in effs.values())
    assert proj["sensitivity_8dev_10x_worse_link"] < effs["8"]


def test_tool_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, "-m", "hso_tpu_torch.tools.bench_distributed_ba"],
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 2 and res.stdout == "" and "cpu=1" in res.stderr

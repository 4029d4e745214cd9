"""The stage ablation (``hso_tpu_torch.tools.profile_ablate``) on the CPU.

* Each of the six stubs (the seed sweep, the matcher, the coarse tracker as
  the FC and as the IC tracker, the pose LM, the candidate selection) returns
  the keys, shapes, dtypes and device of the real function, on the calls the
  real step made on the same inputs (one frame forced through each tracker).
* After every variant has run at ``frames=2``, each name of ``fused_step``
  the tool may replace is the original object again, and the ``full``
  variant gives the unpatched step's checksum (the tool itself holds its
  trajectory to the unpatched step's bit for bit).
* The tool refuses to run without a card unless asked for the CPU.
"""

import os
import subprocess
import sys

import pytest
import torch

from hso_tpu_torch.pipeline import fused_step
from hso_tpu_torch.tools import profile_ablate as pa

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tensors(x, path=""):
    if isinstance(x, torch.Tensor):
        yield path, x
    elif isinstance(x, dict):
        for k in sorted(x):
            yield from _tensors(x[k], f"{path}/{k}")
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            yield from _tensors(v, f"{path}/{i}")
    else:
        yield path, type(x)


def contract(x) -> list:
    """Keys, shapes, dtypes and devices of a result."""
    return [(p, (tuple(t.shape), t.dtype, t.device) if isinstance(t, torch.Tensor) else t)
            for p, t in _tensors(x)]


@pytest.fixture(scope="module")
def recorded():
    """The real functions' calls and results in two whole steps on the CPU,
    one through the FC tracker and one through the IC tracker."""
    res = pa.Resumed("cpu", 1)
    calls = {}

    def recording(name, fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            calls.setdefault(name, (a, k, out))
            return out
        return wrapped

    real_make = fused_step.make_coarse_tracker

    def make(cam, **kw):
        track = real_make(cam, **kw)
        name = "coarse_ic" if kw["inverse"] else "coarse_fc"
        return lambda *a: calls.setdefault(name, (a, (cam, kw), track(*a)))[2]

    patches = {n: recording(n, getattr(fused_step, n)) for n in
               ("update_seeds", "match_points", "optimize_pose", "select_candidates")}
    patches["make_coarse_tracker"] = make
    with pa.patched(patches):
        step = res.step()
        for prev_gm in (-1e6, 1e6):            # forces FC, then IC
            gm = torch.full((), prev_gm, dtype=torch.float32)
            out = step(res.imgs[0], res.pyr0, gm, res.T0, res.obs0, res.intensity0,
                       res.exposure0, res.I_rel, res.snap, res.seeds0, res.px_err,
                       torch.zeros((2, res.n_points), dtype=torch.int32))
            assert bool(out["used_fc"]) == (prev_gm < 0)
    assert sorted(calls) == ["coarse_fc", "coarse_ic", "match_points", "optimize_pose",
                             "select_candidates", "update_seeds"]
    return calls


@pytest.mark.parametrize("name", ["update_seeds", "match_points", "coarse_fc", "coarse_ic",
                                  "optimize_pose", "select_candidates"])
def test_stub_keeps_the_real_contract(recorded, name):
    args, kw, real = recorded[name]
    if name.startswith("coarse"):
        cam, make_kw = kw
        stub = pa.stub_make_coarse_tracker(cam, **make_kw)(*args)
    else:
        stub = getattr(pa, f"stub_{name}")(*args, **kw)
    assert contract(stub) == contract(real)
    if name.startswith("coarse"):               # the initial guess comes back
        assert torch.equal(stub["T_cur_ref"], args[5].to(torch.float32))
        assert torch.equal(stub["exposure_ratio"], torch.as_tensor(args[6]).reshape(()))


def test_every_variant_restores_the_names_and_full_is_the_unpatched_step():
    originals = {k: getattr(fused_step, k) for k in pa.STAGE_NAMES}
    res = pa.Resumed("cpu", 2)
    chk, traj = res.run(res.step(), 2)
    doc = pa.ablate("cpu", frames=2, reps=1)
    assert all(getattr(fused_step, k) is v for k, v in originals.items())
    assert doc["head"]["full_equals_unpatched"] and doc["head"]["names_restored"]
    rows = {r["variant"]: r for r in doc["rows"]}
    assert list(rows) == [name for name, _ in pa.VARIANTS]
    assert rows["full"]["checksum"] == float(chk)
    assert torch.isfinite(traj).all()
    for row in doc["rows"]:
        assert row["host_ms_per_frame"] > 0
        assert row["device_busy_ms_per_frame"].startswith("not measured")
    assert rows["-seeds-match-track-pose"]["host_ms_marginal"] > 0
    assert "(marginal" in pa.text_lines(doc)[1]


def test_tool_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, "-m", "hso_tpu_torch.tools.profile_ablate"],
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 2 and res.stdout == "" and "cpu=1" in res.stderr

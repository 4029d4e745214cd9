"""The port's BA glue (``hso_tpu_torch.pipeline.ba_glue``) against the JAX
package's on the map of ``artifacts/bench_boot.npz``, loaded into both
handlers: the covisible window around the last keyframe and the BA problem
seen through ``solve_capture`` are the same (integers exact, host floats
bitwise: the assembly is host numpy on both sides); the solver's poses agree
to 1.2e-6 (what ``tests/test_torch_local_ba.py`` measured on the bench's
captured problem), inverse distances to 1e-4 relative, chi2 to 1e-4
relative; the write-back (inverse distances, stripped observations) follows."""

import numpy as np
import pytest
import torch

from hso_tpu.cameras import PinholeCamera as JaxCamera
from hso_tpu.config import Config as JaxConfig
from hso_tpu.pipeline import ba_glue as jg
from hso_tpu.pipeline.frame_handler import FrameHandler as JaxHandler
from hso_tpu.utils.checkpoint import load_checkpoint as jax_load
from hso_tpu_torch.ba.local_ba import local_bundle_adjustment
from hso_tpu_torch.bench import BOOT_NPZ, bench_camera
from hso_tpu_torch.config import Config
from hso_tpu_torch.pipeline import ba_glue as tg
from hso_tpu_torch.pipeline.frame_handler import FrameHandler
from hso_tpu_torch.utils.checkpoint import load_checkpoint

torch.set_num_threads(1)


def run(glue, handler):
    """Covisibility, then the BA around the last keyframe with the problem
    captured; returns (window, (args, kwargs), result)."""
    seen = []
    old = glue.solve_capture
    glue.solve_capture = lambda args, kw: seen.append((args, kw))
    try:
        center = handler.kfs.frames[-1]
        window = glue.covisible_keyframes(handler, center)
        res = glue.run_local_ba(handler, center)
    finally:
        glue.solve_capture = old
    assert len(seen) == 1
    return window, seen[0], res


@pytest.fixture(scope="module")
def both():
    hj = JaxHandler(JaxCamera(640, 480, 400.0, 400.0, 320.0, 240.0), JaxConfig())
    jax_load(hj, BOOT_NPZ, resume_stage="default")
    ht = FrameHandler(bench_camera(), Config(), device="cpu")
    load_checkpoint(ht, BOOT_NPZ, resume_stage="default")
    return dict(hj=hj, ht=ht, j=run(jg, hj), t=run(tg, ht))


def flat(args):
    T, free, idist, pvalid, obs = args
    out = {"T_kf": T, "free": free, "idist": idist, "pvalid": pvalid}
    out.update({f"obs_{k}": v for k, v in obs.items()})
    return {k: np.asarray(v) for k, v in out.items()}


def test_covisible_window(both):
    assert both["t"][0] == both["j"][0] and len(both["t"][0]) >= 3


def test_problem_is_the_same(both):
    (aj, kwj), (at, kwt) = both["j"][1], both["t"][1]
    assert kwj == kwt
    fj, ft = flat(aj), flat(at)
    assert fj.keys() == ft.keys()
    for k in fj:
        assert fj[k].dtype == ft[k].dtype and np.array_equal(fj[k], ft[k]), k
    assert int(ft["pvalid"].sum()) > 100 and int(ft["obs_valid"].sum()) > 500


def test_solver_output(both):
    (aj, kw), (at, _) = both["j"][1], both["t"][1]
    j = jg._jitted_local_ba(kw["n_kf"], kw["n_pts"], kw["n_iter"], kw["focal"],
                            kw["strip_px"])(*aj)
    t = local_bundle_adjustment(*at, **kw)
    np.testing.assert_allclose(t["T_kf"].numpy(), np.asarray(j["T_kf"]), rtol=0, atol=1.2e-6)
    pv = flat(at)["pvalid"]
    np.testing.assert_allclose(t["idist"].numpy()[pv], np.asarray(j["idist"])[pv], rtol=1e-4)
    np.testing.assert_allclose(float(t["chi2_final"]), float(j["chi2_final"]), rtol=1e-3)


def test_write_back(both):
    rj, rt = both["j"][2], both["t"][2]
    for k in ("n_obs", "n_points", "n_kfs"):
        assert rj[k] == rt[k], k
    np.testing.assert_allclose(rt["chi2_init"], rj["chi2_init"], rtol=1e-4)
    assert abs(rt["n_stripped"] - rj["n_stripped"]) <= max(1, rj["n_obs"] // 1000)
    pj, pt = both["hj"].points, both["ht"].points
    np.testing.assert_allclose(pt.idist, pj.idist, rtol=1e-4)
    n_diff = sum(int((a.obs["valid"] != b.obs["valid"]).sum())
                 for a, b in zip(both["hj"].kfs.frames, both["ht"].kfs.frames))
    assert n_diff <= max(1, rj["n_obs"] // 1000)

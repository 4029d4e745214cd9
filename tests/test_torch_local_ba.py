"""Port ↔ JAX parity of the windowed Schur-complement BA (CPU):
``residuals_and_jacobians``, ``compute_deltas``, ``build_reduced_system``,
``_schur_solve`` and ``local_bundle_adjustment``.

Inputs: ``artifacts/bench_ba.npz``, the BA problem the JAX bench captured
from its live pipeline (16 keyframe slots, 5 free; 2,048 point slots, 332
valid; 1,093 observations), and the synthetic ring problems of
``tests/test_local_ba.py`` (``hso_tpu_torch.testing.ba_problem``).

Tolerances, and why.  Residuals and Jacobians are the same float32
expressions: 1e-5 relative (measured 0).  The reduced system sums over 32k
cells in another order (a one-hot matmul on each side): ``H_cc`` and ``g_c``
to 1e-4 relative to their largest entry.  After 10 LM iterations, each with a
96×96 LU solve: poses to 1e-5 (measured 1.2e-6 on the captured problem; the
ill-conditioned noisy ring 5e-5, measured 1.5e-5), inverse distances to 1e-4
relative (measured 6.5e-5), chi2 to 1e-3 relative (a noise-free problem ends
at the float32 floor, where it is held to 1e-9 of the start); the inlier test compares
a residual with a threshold, so at most 0.1 % of the valid cells may differ
(measured 0).  A fixed keyframe does not move: to 1e-7.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hso_tpu.ba import local_ba as jb
from hso_tpu_torch import testing
from hso_tpu_torch.ba import local_ba as tb

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BA_NPZ = os.path.join(ROOT, "artifacts", "bench_ba.npz")


def _captured():
    z = np.load(BA_NPZ, allow_pickle=False)
    obs = {k[4:]: z[k] for k in z.files if k.startswith("obs_")}
    kw = json.loads(bytes(z["kw_json"]).decode())
    return dict(T_kf=z["T_kf"], free=z["free"], idist=z["idist"], point_valid=z["pvalid"],
                obs=obs, K=kw["n_kf"], P=kw["n_pts"], n_iter=kw["n_iter"], focal=kw["focal"])


def _synthetic(seed, noise_px):
    prob = testing.ba_problem(seed=seed, noise_px=noise_px)
    prob.update(n_iter=10, focal=450.0)
    return prob


#: pose tolerance after the solve; the noisy ring is ill-conditioned (its
#: estimate sits 1e-2 from the truth, ``tests/test_local_ba.py``), so float32
#: sums in another order move it further: measured 1.5e-5
POSE_TOL = {"captured": 1e-5, "ring": 1e-5, "ring_noisy": 5e-5, "ring_fixed": 1e-5}
PROBLEMS = {
    "captured": _captured,
    "ring": lambda: _synthetic(0, 0.0),
    "ring_noisy": lambda: _synthetic(2, 0.4),
    "ring_fixed": lambda: _synthetic(4, 0.0),
}


def _sides(prob):
    j = {k: jnp.asarray(v) for k, v in prob["obs"].items()}
    t = {k: torch.as_tensor(np.array(v)) for k, v in prob["obs"].items()}
    return j, t


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / max(np.abs(np.asarray(b)).max(),
                                                                    1e-30))


@functools.lru_cache(maxsize=None)
def _solve(name):
    prob = PROBLEMS[name]()
    oj, ot = _sides(prob)
    kw = dict(n_kf=prob["K"], n_pts=prob["P"], n_iter=prob["n_iter"], focal=prob["focal"])
    rj = jb.local_bundle_adjustment(jnp.asarray(prob["T_kf"]), jnp.asarray(prob["free"]),
                                    jnp.asarray(prob["idist"]), jnp.asarray(prob["point_valid"]),
                                    oj, **kw)
    rt = tb.local_bundle_adjustment(torch.as_tensor(prob["T_kf"]), torch.as_tensor(prob["free"]),
                                    torch.as_tensor(prob["idist"]),
                                    torch.as_tensor(prob["point_valid"]), ot, **kw)
    return dict(name=name, prob=prob, oj=oj, ot=ot,
                jax={k: np.asarray(v) for k, v in rj.items() if k != "deltas"},
                torch={k: v.numpy() for k, v in rt.items() if k != "deltas"},
                deltas=(rj["deltas"], rt["deltas"]))


@pytest.fixture(params=list(PROBLEMS))
def solved(request):
    return _solve(request.param)


def test_residuals_and_jacobians(solved):
    prob = solved["prob"]
    rj = jb.residuals_and_jacobians(jnp.asarray(prob["T_kf"]), jnp.asarray(prob["idist"]),
                                    solved["oj"])
    rt = tb.residuals_and_jacobians(torch.as_tensor(prob["T_kf"]),
                                    torch.as_tensor(prob["idist"]), solved["ot"])
    valid = prob["obs"]["valid"]
    for a, b, name in zip(rj, rt, ("r", "J_rho", "J_host", "J_target", "sqrt_info")):
        a, b = np.asarray(a)[valid], b.numpy()[valid]
        assert _rel(b, a) <= 1e-5, name


def test_deltas_and_reduced_system(solved):
    prob = solved["prob"]
    T, idist = prob["T_kf"], prob["idist"]
    dj = jb.compute_deltas(jnp.asarray(T), jnp.asarray(idist), solved["oj"], prob["focal"])
    dt = tb.compute_deltas(torch.as_tensor(T), torch.as_tensor(idist), solved["ot"],
                           prob["focal"])
    for a, b in zip(dj, dt):
        np.testing.assert_allclose(float(b), float(a), rtol=1e-5)
    sj = jb.build_reduced_system(jnp.asarray(T), jnp.asarray(idist), solved["oj"], dj,
                                 prob["K"], prob["P"])
    st = tb.build_reduced_system(torch.as_tensor(T), torch.as_tensor(idist), solved["ot"], dt,
                                 prob["K"], prob["P"])
    for k in ("H_cc", "g_c", "H_pp", "g_p", "W"):
        assert _rel(st[k].numpy(), sj[k]) <= 1e-4, k
    np.testing.assert_allclose(float(st["chi2"]), float(sj["chi2"]), rtol=1e-4)
    H = st["H_cc"].numpy()
    np.testing.assert_allclose(H, H.T, rtol=0, atol=1e-5 * np.abs(H).max())


def test_schur_solve(solved):
    prob = solved["prob"]
    T, idist = prob["T_kf"], prob["idist"]
    dj, dt = solved["deltas"]
    sj = jb.build_reduced_system(jnp.asarray(T), jnp.asarray(idist), solved["oj"], dj,
                                 prob["K"], prob["P"])
    st = tb.build_reduced_system(torch.as_tensor(T), torch.as_tensor(idist), solved["ot"], dt,
                                 prob["K"], prob["P"])
    lam = 1e-3
    cj, pj = jb._schur_solve(sj, jnp.asarray(prob["free"]), jnp.float32(lam), prob["K"])
    ct, pt = tb._schur_solve(st, torch.as_tensor(prob["free"]), torch.tensor(lam), prob["K"])
    assert _rel(ct.numpy(), cj) <= 1e-3
    assert _rel(pt.numpy(), pj) <= 1e-3
    fixed = np.repeat(~prob["free"], 6)
    assert not ct.numpy()[fixed].any()


def test_solution(solved):
    j, t, prob = solved["jax"], solved["torch"], solved["prob"]
    np.testing.assert_allclose(t["T_kf"], j["T_kf"], atol=POSE_TOL[solved["name"]])
    pv = prob["point_valid"]
    np.testing.assert_allclose(t["idist"][pv], j["idist"][pv], rtol=1e-4)
    np.testing.assert_array_equal(t["idist"][~pv], prob["idist"][~pv])
    np.testing.assert_allclose(float(t["chi2_init"]), float(j["chi2_init"]), rtol=1e-4)
    # a noise-free problem ends at the float32 floor (chi2 ≈ 1e-13): there the
    # relative test gives way to one against the start
    np.testing.assert_allclose(float(t["chi2_final"]), float(j["chi2_final"]), rtol=1e-3,
                               atol=1e-9 * float(j["chi2_init"]))
    assert float(t["chi2_final"]) <= float(t["chi2_init"])
    valid = prob["obs"]["valid"]
    assert (t["obs_inlier"] != j["obs_inlier"])[valid].sum() <= 0.001 * valid.sum()
    assert not t["obs_inlier"][~valid].any()


def test_fixed_keyframes_stay_fixed(solved):
    t, prob = solved["torch"], solved["prob"]
    fixed = ~prob["free"]
    np.testing.assert_allclose(t["T_kf"][fixed], prob["T_kf"][fixed], rtol=0, atol=1e-7)


def test_noise_free_ring_converges_to_ground_truth():
    solved = _solve("ring")
    t, prob = solved["torch"], solved["prob"]
    assert float(t["chi2_final"]) < float(t["chi2_init"]) * 1e-3
    for k in range(prob["n_kf"]):
        d = np.asarray(t["T_kf"][k], np.float64) - prob["T_gt"][k]
        assert np.abs(d).max() < 1e-3
    id_err = np.abs(t["idist"][:prob["n_pts"]] - prob["idist_gt"]) / prob["idist_gt"]
    assert np.median(id_err) < 1e-3


def test_host_grouping_is_a_one_hot_matmul():
    """The host grouping is an order-fixed sum: a second build is bitwise
    equal, and it agrees with an explicit loop over points."""
    prob = testing.ba_problem(n_kf=4, n_pts=40, K=5, P=48, seed=7, noise_px=0.3)
    ot = {k: torch.as_tensor(np.array(v)) for k, v in prob["obs"].items()}
    T, idist = torch.as_tensor(prob["T_kf"]), torch.as_tensor(prob["idist"])
    d = tb.compute_deltas(T, idist, ot, 450.0)
    a = tb.build_reduced_system(T, idist, ot, d, 5, 48)
    b = tb.build_reduced_system(T, idist, ot, d, 5, 48)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # g_c by a loop over points (float64)
    r, _, J_h, J_t, si = (x.double() for x in tb.residuals_and_jacobians(T, idist, ot))
    rn = tb.residual_norms(r, ot, si)
    delta = torch.where(ot["is_edgelet"], d[1].double(), d[0].double())
    w = torch.where(rn <= delta, 1.0, delta / rn.clamp_min(1e-12))
    iw = torch.where(ot["valid"], w, 0.0) * si * si
    g = torch.zeros(5, 6, dtype=torch.float64)
    for p in range(48):
        for k in range(5):
            wr = r[p, k] * iw[p, k]
            g[k] -= J_t[p, k].T @ wr
            g[int(ot["host"][p])] -= J_h[p, k].T @ wr
    np.testing.assert_allclose(a["g_c"].numpy(), g.reshape(-1).numpy(), rtol=0,
                               atol=1e-5 * float(g.abs().max()))

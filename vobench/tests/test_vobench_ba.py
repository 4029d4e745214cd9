"""The reference of the windowed BA and the tap that samples the timed path's
solves, on the CPU.

    python -m pytest vobench/tests/test_vobench_ba.py -q
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from vobench import ba_tap  # noqa: E402
from vobench.reference import ba  # noqa: E402


def made_up_problem(K: int = 6, P: int = 160, seed: int = 0, focal: float = 450.0):
    """A windowed-BA problem as the handler hands it to its solver: keyframes
    along a short path, points seen from their host, observed in the others
    with half a pixel of noise, the start off by a few percent in depth and a
    millimetre in pose; keyframe 0 held fixed."""
    rng = np.random.default_rng(seed)
    T = np.zeros((K, 3, 4))
    for k in range(K):
        T[k] = ba.se3_exp(torch.tensor(np.r_[0.1 * k, 0.02 * k, 0.0, 0.0, 0.01 * k, 0.0][None])
                          ).numpy()[0]
    host = rng.integers(0, K, P)
    xy = rng.uniform(-0.5, 0.5, (P, 2))
    f = np.c_[xy, np.ones(P)]
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    dist = rng.uniform(2.0, 5.0, P)
    Rh, th = T[host, :, :3], T[host, :, 3]
    X = np.einsum("pji,pj->pi", Rh, f * dist[:, None] - th)
    pT = np.einsum("kij,pj->pki", T[:, :, :3], X) + T[None, :, :, 3]
    meas = pT[..., :2] / pT[..., 2:3] + rng.normal(scale=0.5 / focal, size=(P, K, 2))
    valid = (rng.random((P, K)) < 0.6) & (np.arange(K)[None] != host[:, None])
    edge = rng.random((P, K)) < 0.3
    ang = rng.uniform(0, np.pi, (P, K))
    grad = np.stack([np.cos(ang), np.sin(ang)], -1)
    level = rng.integers(0, 3, (P, K))
    T0 = T.copy()
    for k in range(1, K):
        T0[k] = (np.concatenate([ba.se3_exp(torch.tensor(rng.normal(scale=1e-3, size=(1, 6))))
                                 .numpy()[0], [[0, 0, 0, 1]]]) @ np.r_[T[k], [[0, 0, 0, 1]]])[:3]
    idist0 = (1.0 / dist) * (1.0 + rng.normal(scale=0.03, size=P))
    f32 = torch.float32
    obs = dict(meas=torch.tensor(meas, dtype=f32), grad=torch.tensor(grad, dtype=f32),
               is_edgelet=torch.tensor(edge), level=torch.tensor(level, dtype=torch.int32),
               valid=torch.tensor(valid), f_host=torch.tensor(f, dtype=f32),
               host=torch.tensor(host, dtype=torch.int32))
    free = torch.tensor([k > 0 for k in range(K)])
    pvalid = torch.ones(P, dtype=torch.bool)
    args = (torch.tensor(T0, dtype=f32), free, torch.tensor(idist0, dtype=f32), pvalid, obs)
    return args, dict(n_kf=K, n_pts=P, n_iter=10, focal=focal, strip_px=2.0)


def _solve(args, kw):
    from hso_tpu_torch.ba.local_ba import local_bundle_adjustment
    return local_bundle_adjustment(*args, **kw)


def test_the_exponential_is_a_pose():
    xi = torch.tensor([[0.1, -0.2, 0.3, 0.4, -0.1, 0.2], [1.0, 0, 0, 0, 0, 0]], dtype=torch.float64)
    T = ba.se3_exp(xi)
    R = T[:, :, :3]
    assert torch.allclose(R @ R.transpose(1, 2), torch.eye(3, dtype=torch.float64).expand(2, 3, 3))
    assert torch.allclose(T[1], torch.tensor([[1.0, 0, 0, 1], [0, 1, 0, 0], [0, 0, 1, 0]],
                                             dtype=torch.float64))


def test_the_residuals_vanish_at_the_truth():
    args, kw = made_up_problem(seed=1)
    T0, free, id0, pvalid, obs, focal = ba._problem(args, kw)
    obs = dict(obs, meas=torch.zeros_like(obs["meas"]),
               is_edgelet=torch.zeros_like(obs["is_edgelet"]))
    # projecting again what was projected leaves nothing
    proj = -ba.residuals(T0, id0, obs) / obs["scale"][..., None]
    assert ba.residuals(T0, id0, dict(obs, meas=proj)).abs().max() < 1e-12


def test_a_converged_solve_reads_near_zero_and_a_solve_cut_to_none_reads_one():
    """The program's solver on a made-up problem: ten iterations leave almost
    none of the decrease undone; none leave all of it."""
    args, kw = made_up_problem(seed=2)
    sound = ba.solve_gap(args, kw, _solve(args, kw))
    cut = ba.solve_gap(args, dict(kw, n_iter=0), _solve(args, dict(kw, n_iter=0)))
    assert sound["cost_start"] > 2 * sound["cost_reference"]
    assert sound["gap"] is not None and sound["gap"] < 0.01, sound
    assert cut["gap"] == pytest.approx(1.0), cut
    one = ba.solve_gap(args, dict(kw, n_iter=1), _solve(args, dict(kw, n_iter=1)))
    assert sound["gap"] < one["gap"], (sound, one)


def test_a_wrong_answer_reads_high():
    """A solve whose points are written back half way to their start."""
    args, kw = made_up_problem(seed=3)
    out = _solve(args, kw)
    half = dict(out, idist=0.5 * (out["idist"] + args[2]))
    assert ba.solve_gap(args, kw, half)["gap"] > 0.1


def _tapped_run(monkeypatch, seed):
    from hso_tpu_torch.pipeline import ba_glue

    def solver(*a, **kw):
        return {"T_kf": a[0] + 1, "idist": a[2] * 2}

    monkeypatch.setattr(ba_glue, "local_bundle_adjustment", solver)
    tap = ba_tap.Tap(k=3, seed=seed, on_card=False)
    tap.install()
    try:
        outs = []
        for i in range(12):
            a = (torch.full((2, 3, 4), float(i)), torch.ones(2, dtype=torch.bool),
                 torch.full((4,), float(i)), torch.ones(4, dtype=torch.bool), {})
            tap.on = i >= 2
            outs.append(ba_glue.local_bundle_adjustment(*a, n_iter=10))
    finally:
        tap.remove()
    assert ba_glue.local_bundle_adjustment is solver
    return tap, outs


def test_the_tap_keeps_a_sample_and_passes_results_through(monkeypatch):
    tap, outs = _tapped_run(monkeypatch, 5)
    assert [float(o["idist"][0]) for o in outs] == [2.0 * i for i in range(12)]
    assert tap.count == 10 and len(tap.kept) == 3
    picked = []
    for k in tap.kept:
        i = float(k["args"][2][0])
        assert 2 <= i < 12 and float(k["out"]["idist"][0]) == 2 * i
        assert k["kw"]["n_iter"] == 10
        picked.append(i)
    # the seed decides the sample
    assert [float(k["args"][2][0]) for k in _tapped_run(monkeypatch, 5)[0].kept] == picked

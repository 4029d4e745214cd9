"""Trajectory evaluation: the port's TUM and EuRoC readers, association and
file-level ATE against the JAX package's (``hso_tpu/utils/evaluate.py``,
``scripts/evaluate_ate.py::load_any``) on the same seeded files.  Both are
float64 numpy: readers and association must agree exactly, ATE to 1e-12."""

import importlib.util
import os

import numpy as np
import pytest

from hso_tpu.math import se3np as jse3
from hso_tpu.utils import evaluate as J
from hso_tpu_torch.utils import evaluate as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_load_any():
    spec = importlib.util.spec_from_file_location(
        "evaluate_ate", os.path.join(ROOT, "scripts", "evaluate_ate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.load_any


def write_tum(path, stamps, xyz, rng, comment=True):
    with open(path, "w") as fh:
        if comment:
            fh.write("# timestamp tx ty tz qx qy qz qw\n")
        for s, p in zip(stamps, xyz):
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            fh.write(f"{s:.6f} {p[0]:.9f} {p[1]:.9f} {p[2]:.9f} "
                     f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}\n")
        fh.write("\n1.0 2.0 3.0\n")            # a short row: skipped by both


def trajectories(tmp_path, seed=0):
    rng = np.random.default_rng(seed)
    n = 80
    t = np.linspace(0, 4 * np.pi, n)
    gt = np.stack([np.cos(t), np.sin(t), 0.1 * t], axis=1)
    st_g = np.arange(n) / 20.0
    keep = np.sort(rng.choice(n, 30, replace=False))
    st_e = st_g[keep] + rng.uniform(-0.015, 0.015, len(keep))
    est = 0.5 * gt[keep] + 0.01 * rng.normal(size=(len(keep), 3)) + 0.3
    write_tum(tmp_path / "gt.txt", st_g, gt, rng)
    write_tum(tmp_path / "est.txt", st_e, est, rng, comment=False)
    with open(tmp_path / "gt.csv", "w") as fh:      # EuRoC: ns stamps, commas
        fh.write("#timestamp [ns],p_x,p_y,p_z,q_w,q_x,q_y,q_z\n")
        for s, p in zip(st_g, gt):
            fh.write(f"{int(round(s * 1e9))},{p[0]},{p[1]},{p[2]},1,0,0,0\n")
    return tmp_path


def test_load_tum_equal(tmp_path):
    d = trajectories(tmp_path)
    for name in ("gt.txt", "est.txt"):
        sj, rj = J.load_tum(str(d / name))
        st, rt = T.load_tum(str(d / name))
        np.testing.assert_array_equal(st, sj)
        np.testing.assert_array_equal(rt, rj)
        assert rt.shape[1] == 7


@pytest.mark.parametrize("name", ["gt.txt", "gt.csv"])
def test_load_any_equal(tmp_path, name):
    d = trajectories(tmp_path)
    sj, xj = jax_load_any()(str(d / name))
    st, xt = T.load_any(str(d / name))
    np.testing.assert_array_equal(st, sj)
    np.testing.assert_array_equal(xt, xj)
    assert xt.shape[1] == 3


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_dt", [0.005, 0.02, 0.05])
def test_associate_equal(seed, max_dt):
    rng = np.random.default_rng(seed)
    a = np.sort(rng.uniform(0, 10, 60))
    b = rng.uniform(0, 10, 200)                      # unsorted, with near-ties
    b[:20] = a[:20] + rng.choice([-1, 1], 20) * max_dt * 0.5
    ia_j, ib_j = J.associate(a, b, max_dt)
    ia_t, ib_t = T.associate(a, b, max_dt)
    np.testing.assert_array_equal(ia_t, ia_j)
    np.testing.assert_array_equal(ib_t, ib_j)
    assert len(set(ib_t.tolist())) == len(ib_t)      # one to one
    assert T.associate(a, np.zeros(0), max_dt)[0].shape == (0,)


@pytest.mark.parametrize("with_scale", [True, False])
def test_evaluate_tum_files_equal(tmp_path, with_scale):
    d = trajectories(tmp_path)
    rj = J.evaluate_tum_files(str(d / "est.txt"), str(d / "gt.txt"), with_scale=with_scale)
    rt = T.evaluate_tum_files(str(d / "est.txt"), str(d / "gt.txt"), with_scale=with_scale)
    assert rt.n_pairs == rj.n_pairs > 10
    for k in ("rmse", "mean", "median", "max", "scale"):
        assert abs(getattr(rt, k) - getattr(rj, k)) <= 1e-12, k
    with pytest.raises(ValueError):
        T.evaluate_tum_files(str(d / "est.txt"), str(d / "gt.txt"), max_dt=1e-9)


def test_trajectory_xyz_equal():
    rng = np.random.default_rng(5)
    traj = [(float(k), jse3.exp(rng.normal(0, 0.3, 6))) for k in range(12)]
    np.testing.assert_array_equal(T.trajectory_xyz(traj), J.trajectory_xyz(traj))

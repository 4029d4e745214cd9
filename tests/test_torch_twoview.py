"""The port's two-view geometry (``hso_tpu_torch.math.epipolar_geometry``)
against the JAX package's on the fixtures of ``tests/test_twoview.py``: host
numpy in float64 on both sides, so every result is the same to the last bit
(the RANSAC draws come from the same ``seed``)."""

import numpy as np
import pytest

from hso_tpu.math import epipolar_geometry as jeg
from hso_tpu_torch.math import epipolar_geometry as teg
from test_twoview import FOCAL, _outlier_pair, make_view_pair


def same(a, b):
    """Two results (dicts, arrays, scalars or None) hold the same bits."""
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("planar,seed", [(False, 0), (True, 0), (True, 3), (False, 5)])
def test_twoview_model_selection_same_bits(planar, seed):
    f1, f2, _ = make_view_pair(planar, seed=seed)
    a = teg.recover_pose_twoview(f1, f2, FOCAL)
    b = jeg.recover_pose_twoview(f1, f2, FOCAL)
    assert a is not None and same(a, b)


@pytest.mark.parametrize("fn", ["recover_pose_ransac", "recover_pose_homography_ransac"])
def test_each_model_same_bits(fn):
    f1, f2, _ = make_view_pair(True, seed=3)
    assert same(getattr(teg, fn)(f1, f2, FOCAL), getattr(jeg, fn)(f1, f2, FOCAL))


@pytest.mark.parametrize("method,eps", [("5pt", 0.4), ("8pt", 0.2), ("5pt", 0.6)])
def test_ransac_with_outliers_same_bits(method, eps):
    f1, f2, _ = _outlier_pair(1, eps)
    a = teg.recover_pose_ransac(f1, f2, FOCAL, n_iter=100, seed=1, method=method)
    b = jeg.recover_pose_ransac(f1, f2, FOCAL, n_iter=100, seed=1, method=method)
    assert same(a, b)


def test_minimal_solvers_and_triangulation_same_bits():
    rng = np.random.default_rng(0)
    uv1, uv2 = rng.uniform(-0.5, 0.5, (5, 2)), rng.uniform(-0.5, 0.5, (5, 2))
    ca = teg._essential_candidates_5pt(uv1, uv2)
    cb = jeg._essential_candidates_5pt(uv1, uv2)
    assert len(ca) == len(cb) and all(same(x, y) for x, y in zip(ca, cb))
    u8a, u8b = rng.uniform(-0.5, 0.5, (12, 2)), rng.uniform(-0.5, 0.5, (12, 2))
    assert same(teg._essential_from_8pt(u8a, u8b), jeg._essential_from_8pt(u8a, u8b))
    assert same(teg._homography_dlt(u8a, u8b), jeg._homography_dlt(u8a, u8b))
    f1, f2, T = make_view_pair(False, seed=2)
    assert same(teg.triangulate_midpoint(T, f1, f2), jeg.triangulate_midpoint(T, f1, f2))
    assert same(teg.median_reproj_error(T, f1, f2, FOCAL),
                jeg.median_reproj_error(T, f1, f2, FOCAL))

"""The port's map model (``hso_tpu_torch.mapmodel.structures``) against the
JAX package's: one seeded sequence of ``alloc``, ``release``,
``register_obs``, ``live_obs``, BA-style strips, ``gc_stale`` and
``positions`` drives both point tables and keyframe registries, and every
array, index and free list agrees exactly; ``crop_window`` gives the same
bits.  One difference is the port's on purpose: a row that ``alloc`` hands
out starts with ``n_succ``/``n_fail`` at 0, where the JAX table keeps the
previous occupant's counts."""

import numpy as np
import pytest

from hso_tpu.mapmodel import structures as js
from hso_tpu_torch.mapmodel import structures as ts
from hso_tpu_torch.math import se3np

P, KF, SLOTS = 192, 24, 40
ARRAYS = ("valid", "type", "host_kf", "host_px", "host_f", "host_level", "species", "grad",
          "idist", "host_win", "host_anchor", "patch_kf", "patch_px", "patch_f", "patch_level",
          "patch_grad", "patch_win", "patch_anchor", "last_obs_kf")


def drive(mod, seed=0):
    """The seeded life of a small map on module ``mod``'s structures."""
    rng = np.random.default_rng(seed)
    pts = mod.PointTable(P)
    kfs = mod.KeyframeWindow(k_all_max=64, recent=8)
    pts.kfs = kfs
    log = {"alloc": [], "gc": [], "live": [], "pos": []}
    for kf in range(KF):
        T = se3np.exp(np.r_[rng.normal(0, 0.3, 3), rng.normal(0, 0.05, 3)])
        f = mod.Frame(frame_id=kf, timestamp=float(kf), T_f_w=T, data={"pyr": ()},
                      obs=mod.empty_obs(SLOTS))
        kfs.add(f)
        idx = pts.alloc(int(rng.integers(0, 28)))
        m = len(idx)
        pts.valid[idx] = True
        pts.type[idx] = rng.integers(1, 5, m)
        pts.host_kf[idx] = kf
        pts.host_px[idx] = rng.uniform(0, 600, (m, 2))
        f_h = rng.normal(0, 0.3, (m, 3))
        f_h[:, 2] = 1.0
        pts.host_f[idx] = f_h / np.linalg.norm(f_h, axis=1, keepdims=True)
        pts.idist[idx] = rng.uniform(0.1, 1.0, m)
        pts.host_win[idx] = rng.normal(0, 1, (m, ts.HOST_WIN, ts.HOST_WIN))
        pts.host_anchor[idx] = rng.integers(0, 500, (m, 2))
        pts.init_patch_from_host(idx)
        log["alloc"].append(idx.copy())
        # this keyframe observes some live points
        live = np.nonzero(pts.valid)[0]
        sel = rng.choice(live, min(len(live), SLOTS - 4), replace=False) if len(live) else live
        o = f.obs
        o["valid"][:len(sel)] = True
        o["point_id"][:len(sel)] = sel
        o["px"][:len(sel)] = rng.uniform(0, 600, (len(sel), 2))
        pts.register_obs(f)
        # BA strips some observations in older keyframes
        for _ in range(3):
            k = int(rng.integers(0, kf + 1))
            s = int(rng.integers(0, SLOTS))
            kfs.frames[k].obs["valid"][s] = False
            kfs.frames[k].obs["point_id"][s] = -1
        # releases (lifecycle deaths), then the stale-point collector
        if len(live):
            pts.release(rng.choice(live, min(len(live), 3), replace=False))
        log["gc"].append(pts.gc_stale(kf, grace_kfs=5, pressure=0.4))
        log["live"].append([pts.live_obs(p, kfs.frames) for p in range(P)])
        log["pos"].append(pts.positions(kfs.poses))
    return pts, kfs, log


@pytest.fixture(scope="module")
def both():
    return drive(js), drive(ts)


def test_point_tables_equal(both):
    (pj, _, _), (pt, _, _) = both
    for name in ARRAYS:
        a, b = getattr(pj, name), getattr(pt, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert pj._free == pt._free
    assert pj.obs_refs == pt.obs_refs
    assert int(pt.valid.sum()) > 20


def test_sequence_of_calls_equal(both):
    (_, _, lj), (_, _, lt) = both
    assert all(np.array_equal(a, b) for a, b in zip(lj["alloc"], lt["alloc"]))
    assert lj["gc"] == lt["gc"] and sum(lt["gc"]) > 0
    assert lj["live"] == lt["live"]
    assert all(np.array_equal(a, b) for a, b in zip(lj["pos"], lt["pos"]))


def test_keyframe_registries_equal(both):
    (_, kj, _), (_, kt, _) = both
    assert np.array_equal(kj.poses, kt.poses) and np.array_equal(kj.exposure, kt.exposure)
    assert len(kj.frames) == len(kt.frames) == KF
    for a, b in zip(kj.frames, kt.frames):
        assert (a.kf_index, a.is_keyframe, a.data is None) == (b.kf_index, b.is_keyframe,
                                                              b.data is None)
        for k in a.obs:
            assert np.array_equal(a.obs[k], b.obs[k]), k
    # only the `recent` newest keyframes keep their pyramid
    assert [f.data is None for f in kt.frames] == [True] * (KF - 8) + [False] * 8
    assert np.array_equal(kj.frames[3].pos(), kt.frames[3].pos())


@pytest.mark.parametrize("w_in,seed", [(44, 0), (24, 1), (40, 2)])
def test_crop_window_same_bits(w_in, seed):
    rng = np.random.default_rng(seed)
    n = 64
    win = rng.normal(0, 1, (n, w_in, w_in)).astype(np.float32)
    level = rng.integers(0, 3, n).astype(np.int32)
    anchor = rng.integers(0, 200, (n, 2)).astype(np.int32)
    px = ((anchor + rng.uniform(-4, w_in + 4, (n, 2))) * (1 << level)[:, None]).astype(np.float32)
    a = ts.crop_window(win, anchor, px, level)
    b = js.crop_window(win, anchor, px, level)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert a[0].shape == (n, ts.HOST_WIN, ts.HOST_WIN)


@pytest.mark.parametrize("mod,kept", [(js, True), (ts, False)])
def test_reused_row_counters(mod, kept):
    """A released row handed out again: the JAX table keeps the old point's
    n_succ/n_fail (a TEMPORARY point there dies at its first failed match,
    since the rule is n_fail > 3); the port starts the new point at 0."""
    pts = mod.PointTable(8)
    (row,) = pts.alloc(1)
    pts.valid[row] = True
    pts.n_succ[row], pts.n_fail[row] = 7, 16
    pts.release([row])
    (again,) = pts.alloc(1)
    assert again == row
    counts = (int(pts.n_succ[row]), int(pts.n_fail[row]))
    assert counts == ((7, 16) if kept else (0, 0))

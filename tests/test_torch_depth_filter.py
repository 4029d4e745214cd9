"""Port ↔ JAX parity of the depth filter (CPU): ``init_seeds``,
``update_seeds`` (with and without ``update_mask``), ``harvest_and_prune``
(with and without the activation refinement) and ``gather_seed_windows``.

The scene is the plane of ``tests/test_depth_filter.py`` at S_MAX = 512;
detections come from the JAX ``detect_features`` and are carried over as
numpy; both sides read the same pyramids (the JAX package's, as numpy), so
the comparison isolates the depth filter.  On the CPU the port's sweep goes
through the plain versions of kernels K2, K4 and K6.

Tolerances, and why.  Slot allocation and every integer or boolean member are
data movement: exact.  A sweep matches each seed by a ZMNCC line search
(integer step, exact unless two steps tie) and ten float32 alignment steps,
then triangulates over a short baseline, which amplifies a 1e-4 px difference
to ~1e-4 in inverse depth: ``mu`` is held to 1e-3, ``sigma2`` to 1e-4, the
matched pixel to 2e-2 (the alignment's 5e-3 px at its search level, times
2^level in level-0 pixels) and the recorded unit-plane observation to that
over the focal length (5e-5), on rows both sides matched.  A row
whose score sits on a gate (0.5 / 0.8 NCC, the 1.5× ambiguity, the 0.4 and 0.7
direction cosines) may be matched by one side only: at most 1 % of the live
rows per sweep.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hso_tpu.cameras import PinholeCamera as JaxPinhole
from hso_tpu.image.pyramid import build_frame_pyramids as jax_pyramids
from hso_tpu.mapping import depth_filter as jdf
from hso_tpu.ops.detect import detect_features
from hso_tpu_torch.cameras import PinholeCamera
from hso_tpu_torch.mapping import depth_filter as tdf
from hso_tpu_torch.math import se3np
from hso_tpu_torch.utils.checkpoint import seeds_from_numpy, seeds_to_numpy
from hso_tpu_torch.utils.synthetic import PlaneScene

torch.set_num_threads(1)

S_MAX = 512
t = torch.as_tensor
FLOAT_STATE = ("mu", "sigma2", "a", "b", "z_range", "converge_thresh", "n_updates")
EXACT_STATE = ("valid", "host", "level", "species", "batch_id", "host_anchor", "obs_count",
               "temp_point", "px", "f", "grad", "host_win")


def _np_tree(d):
    return {k: np.array(v) for k, v in d.items()}


def _det_t(det):
    return {k: t(det[k]) for k in ("px", "level", "species", "grad", "valid")}


def _det_j(det):
    return {k: jnp.asarray(v) for k, v in det.items()}


@pytest.fixture(scope="module")
def setup():
    cam_j = JaxPinhole(640, 480, 400.0, 400.0, 320.0, 240.0)
    cam = PinholeCamera(640, 480, 400.0, 400.0, 320.0, 240.0)
    scene = PlaneScene(cam, z0=2.0, extent=3.0, seed=11)
    kf = jax_pyramids(jnp.asarray(scene.render()))
    occ = jnp.zeros((-(-480 // 32), -(-640 // 32)), bool)
    det = _np_tree(detect_features(kf["pyr"][:3], kf["sobel_x"], kf["sobel_y"], kf["grad_mean"],
                                   occ, n_out=256))
    f_det = cam.cam2world(det["px"]).astype(np.float32)
    kf_pyr = [np.array(p) for p in kf["pyr"]]
    seeds_j = jdf.init_seeds(jdf.empty_seeds(S_MAX), _det_j(det), kf["pyr"], jnp.asarray(f_det),
                             0, 1, 3.0, 1.0, 150.0)
    frames = []
    for k in range(1, 4):
        T = se3np.exp(np.r_[0.06 * k, 0.02 * k, 0.01 * k, 0.0, 0.0, 0.0])
        cur = jax_pyramids(jnp.asarray(scene.render(T)))
        frames.append((T.astype(np.float32), cur, [np.array(p) for p in cur["pyr"]]))
    return dict(cam=cam, cam_j=cam_j, det=det, f_det=f_det, kf_pyr=kf_pyr, kf_pyr_j=kf["pyr"],
                seeds0=_np_tree(seeds_j), frames=frames,
                px_err=float(np.arctan(1.0 / (2.0 * cam.focal_mean)) * 2.0),
                host_T=np.stack([se3np.identity()] * 4).astype(np.float32),
                host_exp=np.ones(4, np.float32))


def _assert_tables_equal(got, ref, float_tol=1e-7):
    assert set(got) == set(ref)
    for k, v in ref.items():
        a = got[k]
        assert a.dtype == v.dtype and a.shape == v.shape, k
        if k in FLOAT_STATE:
            np.testing.assert_allclose(a, v, rtol=float_tol, atol=float_tol, err_msg=k)
        else:
            np.testing.assert_array_equal(a, v, err_msg=k)


def test_empty_seeds_layout():
    ref = _np_tree(jdf.empty_seeds(32))
    got = seeds_to_numpy(tdf.empty_seeds(32, "cpu"))
    _assert_tables_equal(got, ref, 0.0)
    assert tdf.SEED_FIELDS == jdf.SEED_FIELDS
    assert (tdf.HOST_WIN, tdf.N_OBS_RING, tdf.EDGELET, tdf.GRADIENT) == (
        jdf.HOST_WIN, jdf.N_OBS_RING, jdf.EDGELET, jdf.GRADIENT)


def test_init_seeds_into_an_empty_table(setup):
    s = setup
    got = tdf.init_seeds(tdf.empty_seeds(S_MAX, "cpu"), _det_t(s["det"]),
                         tuple(t(p) for p in s["kf_pyr"]), t(s["f_det"]), 0, 1, 3.0, 1.0, 150.0)
    _assert_tables_equal(seeds_to_numpy(got), s["seeds0"])
    n_det = int(s["det"]["valid"].sum())
    assert int(got["valid"].sum()) == n_det > 100
    assert set(np.unique(s["det"]["level"][s["det"]["valid"]])) >= {0, 1}


@pytest.mark.parametrize("s_max", [S_MAX, 300])
def test_init_seeds_into_a_part_filled_table(setup, s_max):
    """A second keyframe batch: free slots first, in slot order; at 300 slots
    the batch finds fewer free slots (54) than it has detections, and the
    detections beyond them are dropped."""
    s = setup
    det = dict(s["det"])
    rs = np.random.RandomState(1)
    det["valid"] = det["valid"] & (rs.rand(256) < 0.9)
    first_j = jdf.init_seeds(jdf.empty_seeds(s_max), _det_j(s["det"]), s["kf_pyr_j"],
                             jnp.asarray(s["f_det"]), 0, 1, 3.0, 1.0, 150.0)
    first = _np_tree(first_j)
    # free a few slots in the middle, as a harvest would
    first["valid"][10:40:3] = False
    ref = _np_tree(jdf.init_seeds({k: jnp.asarray(v) for k, v in first.items()}, _det_j(det),
                                  s["kf_pyr_j"], jnp.asarray(s["f_det"]), 3, 2, 2.5, 0.8, 200.0))
    got = tdf.init_seeds(seeds_from_numpy(first, "cpu"), _det_t(det),
                         tuple(t(p) for p in s["kf_pyr"]), t(s["f_det"]), 3, 2, 2.5, 0.8, 200.0)
    _assert_tables_equal(seeds_to_numpy(got), ref)
    assert (ref["batch_id"][ref["valid"]] == 2).sum() > 30
    if s_max == 300:
        n_free = int((~first["valid"]).sum())
        assert n_free < int(det["valid"].sum())
        assert (ref["batch_id"][ref["valid"]] == 2).sum() == int(det["valid"][:n_free].sum())


def _sweep_j(s, seeds, frame, mask=None):
    T, cur, _ = frame
    out, stats = jdf.update_seeds(
        {k: jnp.asarray(v) for k, v in seeds.items()}, jnp.asarray(s["host_T"]),
        jnp.asarray(s["host_exp"]), cur["pyr"], cur["sobel_x"], cur["sobel_y"], jnp.asarray(T),
        1.0, s["px_err"], s["cam_j"], update_mask=None if mask is None else jnp.asarray(mask))
    return _np_tree(out), _np_tree(stats)


def _sweep_t(s, seeds, frame, mask=None):
    T, _, pyr = frame
    out, stats = tdf.update_seeds(
        seeds_from_numpy(seeds, "cpu"), t(s["host_T"]), t(s["host_exp"]),
        tuple(t(p) for p in pyr), None, None, t(T.astype(np.float64)), 1.0, s["px_err"],
        s["cam"], update_mask=None if mask is None else t(mask))
    return seeds_to_numpy(out), {k: v.numpy() for k, v in stats.items()}


def _compare_sweep(got, gs, ref, rs, live):
    """One sweep's outputs; returns the rows both sides matched."""
    assert set(gs) == set(rs) == {"n_visible", "n_updated", "px_match", "matched"}
    assert int(gs["n_visible"]) == int(rs["n_visible"])
    flips = int((gs["matched"] != rs["matched"]).sum())
    assert flips <= max(1, live // 100), flips
    assert abs(int(gs["n_updated"]) - int(rs["n_updated"])) <= flips
    both = gs["matched"] & rs["matched"]
    for k in EXACT_STATE:
        if k != "obs_count":
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    same = gs["matched"] == rs["matched"]
    np.testing.assert_array_equal(got["obs_count"][same], ref["obs_count"][same])
    np.testing.assert_array_equal(got["obs_valid"][same], ref["obs_valid"][same])
    np.testing.assert_array_equal(got["b"][same], ref["b"][same])
    # the alignment's 5e-3 px at its search level, times 2^level (≤ 4) in level-0 px
    np.testing.assert_allclose(gs["px_match"][both], rs["px_match"][both], atol=2e-2)
    return both


@pytest.fixture(scope="module")
def swept(setup):
    """Three successive sweeps, each side feeding its own table forward."""
    s = setup
    sj, st = s["seeds0"], s["seeds0"]
    steps = []
    for frame in s["frames"]:
        sj, stats_j = _sweep_j(s, sj, frame)
        st, stats_t = _sweep_t(s, st, frame)
        steps.append((st, stats_t, sj, stats_j))
    return steps


def test_update_seeds_three_successive_frames(setup, swept):
    live = int(setup["seeds0"]["valid"].sum())
    seen = np.zeros(S_MAX, bool)
    for k, (got, gs, ref, rs) in enumerate(swept):
        both = _compare_sweep(got, gs, ref, rs, live)
        assert both.sum() > 0.4 * live, (k, both.sum())
        seen |= gs["matched"] != rs["matched"]
        ok = both & ~seen          # a row matched by one side only diverges from there on
        np.testing.assert_allclose(got["mu"][ok], ref["mu"][ok], atol=1e-3)
        np.testing.assert_allclose(got["sigma2"][ok], ref["sigma2"][ok], atol=1e-4)
        np.testing.assert_allclose(got["obs_uv"][ok], ref["obs_uv"][ok], atol=5e-5)
        np.testing.assert_allclose(got["obs_T"][ok], ref["obs_T"][ok], atol=1e-7)
        np.testing.assert_array_equal(got["n_updates"][ok], ref["n_updates"][ok])
    got, _, ref, _ = swept[-1]
    assert got["obs_count"].max() == 3 and (got["n_updates"] >= 2).sum() > 0.3 * live
    # uncertainty contracted, and the estimate moved toward the true depth
    upd = got["n_updates"] >= 2
    assert np.median(got["sigma2"][upd]) < 0.1 * np.median(setup["seeds0"]["sigma2"][upd])


def test_update_seeds_with_update_mask(setup):
    s = setup
    mask = (np.arange(S_MAX) % 2) == 0
    ref, rs = _sweep_j(s, s["seeds0"], s["frames"][0], mask)
    got, gs = _sweep_t(s, s["seeds0"], s["frames"][0], mask)
    live = int(s["seeds0"]["valid"].sum())
    both = _compare_sweep(got, gs, ref, rs, live)
    assert both.sum() > 0.2 * live and not gs["matched"][~mask].any()
    np.testing.assert_allclose(got["mu"][both], ref["mu"][both], atol=1e-3)
    # rows outside the mask are untouched, b included
    for k in ("mu", "sigma2", "b", "obs_count", "n_updates"):
        np.testing.assert_array_equal(got[k][~mask], s["seeds0"][k][~mask], err_msg=k)
    # the masked sweep saw about half of what the full sweep saw
    _, full = _sweep_t(s, s["seeds0"], s["frames"][0])
    assert 0.3 * int(full["n_visible"]) < int(gs["n_visible"]) < 0.7 * int(full["n_visible"])


def test_update_seeds_is_deterministic_and_pure(setup):
    s = setup
    before = {k: v.copy() for k, v in s["seeds0"].items()}
    a, sa = _sweep_t(s, s["seeds0"], s["frames"][1])
    b, sb = _sweep_t(s, s["seeds0"], s["frames"][1])
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(sa["px_match"], sb["px_match"])
    for k, v in before.items():
        np.testing.assert_array_equal(s["seeds0"][k], v, err_msg=k)


def _harvest_both(seeds, batch_counter, host_T, **kw):
    ref_s, ref_b = jdf.harvest_and_prune({k: jnp.asarray(v) for k, v in seeds.items()},
                                         batch_counter,
                                         None if host_T is None else jnp.asarray(host_T), **kw)
    got_s, got_b = tdf.harvest_and_prune(seeds_from_numpy(seeds, "cpu"), batch_counter,
                                         None if host_T is None else t(host_T), **kw)
    return seeds_to_numpy(got_s), got_b.numpy(), _np_tree(ref_s), np.array(ref_b)


@pytest.mark.parametrize("with_ring", [False, True])
def test_harvest_and_prune_on_swept_seeds(setup, swept, with_ring):
    """The JAX side's table after three sweeps, its variances shrunk so that
    part of it counts as converged; the same table into both harvests."""
    seeds = {k: v.copy() for k, v in swept[-1][2].items()}
    seeds["sigma2"] = np.where(seeds["n_updates"] >= 2, seeds["sigma2"] * 1e-3,
                               seeds["sigma2"]).astype(np.float32)
    got_s, got_b, ref_s, ref_b = _harvest_both(
        seeds, 2, setup["host_T"] if with_ring else None, focal=400.0)
    assert got_b.shape == ref_b.shape == (S_MAX, 15) and got_b.dtype == np.float32
    assert ref_b[:, 0].sum() > 20
    np.testing.assert_array_equal(got_b[:, :2], ref_b[:, :2])            # converged, stale
    np.testing.assert_array_equal(got_b[:, 2:12], ref_b[:, 2:12])
    np.testing.assert_array_equal(got_b[:, 13:], ref_b[:, 13:])
    np.testing.assert_allclose(got_b[:, 12], ref_b[:, 12], rtol=1e-5, atol=1e-7)
    _assert_tables_equal(got_s, ref_s)
    if with_ring:
        # the refinement moved some of the converged estimates
        conv = ref_b[:, 0] > 0.5
        assert (ref_b[conv, 12] != seeds["mu"][conv]).sum() > 5


def test_harvest_kills_stale_batches(setup):
    got_s, got_b, ref_s, ref_b = _harvest_both(setup["seeds0"], 100, None)
    np.testing.assert_array_equal(got_b, ref_b)
    assert int(got_b[:, 1].sum()) == int(setup["seeds0"]["valid"].sum())
    assert not got_s["valid"].any()


def test_activation_rejects_inconsistent_seeds():
    """Converged seeds whose stored matches disagree with the converged depth
    are rejected (folded into stale), consistent ones activate: the synthetic
    ring of the JAX package's own test, through both harvests."""
    cam_f, n = 400.0, 16
    rng = np.random.default_rng(3)
    f = np.concatenate([rng.normal(0, 0.15, (n, 2)), np.ones((n, 1))], -1)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    mu = np.full(n, 0.5, np.float32)
    host_T = np.stack([se3np.identity()] * 4).astype(np.float32)
    views = [se3np.exp(np.r_[0.15 * (k + 1), 0.05 * k, 0.0, 0, 0, 0]) for k in range(4)]
    seeds = seeds_to_numpy(tdf.empty_seeds(64, "cpu"))
    for k, T in enumerate(views):
        p_v = se3np.apply(T, f / mu[:, None])
        uv = p_v[:, :2] / p_v[:, 2:3]
        uv[8:] += rng.normal(0, 6.0 / cam_f, uv[8:].shape)      # a repetitive-texture lock
        seeds["obs_uv"][:n, k] = uv
        seeds["obs_T"][:n, k] = T
        seeds["obs_valid"][:n, k] = True
    seeds["valid"][:n] = True
    seeds["f"][:n] = f
    seeds["mu"][:n] = mu
    seeds["sigma2"][:n] = 1e-6
    seeds["z_range"][:n] = 1.0
    seeds["converge_thresh"][:n] = 100.0
    seeds["batch_id"][:n] = 1
    seeds["obs_count"][:n] = 4
    got_s, got_b, ref_s, ref_b = _harvest_both(seeds, 1, host_T, max_batches=3,
                                               min_activation_obs=3.0, focal=cam_f)
    np.testing.assert_array_equal(got_b[:, :2], ref_b[:, :2])
    assert got_b[:8, 0].all() and not got_b[8:n, 0].any() and got_b[8:n, 1].all()
    np.testing.assert_allclose(got_b[:, 12], ref_b[:, 12], rtol=1e-5)
    np.testing.assert_array_equal(got_s["valid"], ref_s["valid"])
    # the refinement itself
    mu_j, ok_j, d_j = (np.array(x) for x in jdf._activation_refine(
        {k: jnp.asarray(v) for k, v in seeds.items()}, jnp.asarray(host_T), focal=cam_f))
    mu_t, ok_t, d_t = (x.numpy() for x in tdf._activation_refine(
        seeds_from_numpy(seeds, "cpu"), t(host_T), focal=cam_f))
    np.testing.assert_array_equal(ok_t, ok_j)
    np.testing.assert_allclose(mu_t, mu_j, rtol=1e-5)
    np.testing.assert_array_equal(np.isinf(d_t), np.isinf(d_j))
    np.testing.assert_allclose(d_t[:n], d_j[:n], rtol=1e-3, atol=1e-3)


def test_gather_seed_windows(setup):
    s0 = setup["seeds0"]
    idx = np.array([3, 0, 17, 3], np.int32)
    ref = np.array(jdf.gather_seed_windows(jnp.asarray(s0["host_win"]),
                                           jnp.asarray(s0["host_anchor"]), jnp.asarray(idx)))
    got = tdf.gather_seed_windows(t(s0["host_win"]), t(s0["host_anchor"]), t(idx)).numpy()
    assert got.shape == (4, tdf.HOST_WIN ** 2 + 2)
    np.testing.assert_array_equal(got, ref)

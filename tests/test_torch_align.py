"""Port ↔ JAX parity of feature alignment and matching (CPU).

``align_mixed`` + ``ncc`` + gradient sample (the plain version of kernel K4)
against the JAX functions, and against the JAX kernel ``align_match_tpu`` in
Pallas interpret mode; then ``select_candidates`` and ``match_points`` end to
end.  Tolerances: px 5e-3, converged exact, ncc 1e-3, gradient 2e-2, chi2
1 % — ten float32 LM steps whose 64-pixel sums are taken in different orders.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hso_tpu.cameras import PinholeCamera as JaxPinhole
from hso_tpu.ops import window_pallas
from hso_tpu.ops.align import align_mixed as jax_align_mixed, ncc as jax_ncc
from hso_tpu.ops.epipolar import pack_level_windows as jax_pack
from hso_tpu.ops.gatherless import sample_gradient_in_windows as jax_sample_grad
from hso_tpu.track.matcher import (match_points as jax_match_points,
                                   select_candidates as jax_select)
from hso_tpu_torch import testing
from hso_tpu_torch.cameras import PinholeCamera
from hso_tpu_torch.image.pyramid import build_frame_pyramids
from hso_tpu_torch.math import se3np
from hso_tpu_torch.ops import align_cuda
from hso_tpu_torch.ops.align import align_mixed, ncc
from hso_tpu_torch.ops.epipolar import pack_level_windows
from hso_tpu_torch.ops.gatherless import sample_gradient_in_windows
from hso_tpu_torch.track.matcher import match_points, select_candidates
from hso_tpu_torch.utils.synthetic import PlaneScene

torch.set_num_threads(1)

t = torch.as_tensor


@contextlib.contextmanager
def forced_interpret():
    window_pallas.force_interpret(True)
    jax.clear_caches()
    try:
        yield
    finally:
        window_pallas.force_interpret(False)
        jax.clear_caches()


@pytest.fixture(scope="module")
def scene():
    cam = PinholeCamera(320, 240, 200.0, 200.0, 160.0, 120.0)
    return PlaneScene(cam, z0=2.0, extent=2.5, seed=3, tex_size=1024)


@pytest.fixture(scope="module")
def pyr(scene):
    return [p.numpy() for p in build_frame_pyramids(scene.render(), device="cpu")["pyr"][:3]]


@pytest.fixture(scope="module")
def problem(pyr):
    pb = testing.align_problem([p.shape for p in pyr],
                               lambda lvl, cu, cv: testing.bilinear_patch(pyr[lvl], cu, cv),
                               s=64, seed=2)
    windows, anchors, img_hw = pack_level_windows(
        tuple(t(p) for p in pyr), t(pb["level"]), t(pb["px_init"][:, 0]),
        t(pb["px_init"][:, 1]), 24, 3)
    pb.update(windows=windows.numpy(), au=anchors[0].numpy(), av=anchors[1].numpy(),
              hs=img_hw[0].numpy(), ws=img_hw[1].numpy())
    return pb


def _jax_reference(pb, valid):
    j = jnp.asarray
    rm = jax_align_mixed(j(pb["is_edge"]), j(pb["direction"]), j(pb["ref_border"]),
                         j(pb["px_init"]), n_iter=10, valid=j(valid), windows=j(pb["windows"]),
                         anchors=(j(pb["au"]), j(pb["av"])), img_hw=(j(pb["hs"]), j(pb["ws"])))
    score = jax_ncc(j(pb["ref_border"])[:, 1:9, 1:9], rm["cur_patch"])
    gx, gy = jax_sample_grad(j(pb["windows"]), j(pb["au"]), j(pb["av"]),
                             rm["px"][:, 0], rm["px"][:, 1])
    return jax.tree.map(np.asarray, dict(rm, score=score, gx=gx, gy=gy))


def _torch_args(pb, valid):
    return (t(pb["is_edge"]), t(pb["direction"]), t(pb["ref_border"]), t(pb["px_init"]),
            t(valid), t(pb["windows"]), t(pb["au"]), t(pb["av"]), t(pb["hs"]), t(pb["ws"]))


def _check_packed(out8, ref):
    conv = ref["converged"]
    np.testing.assert_array_equal(out8[2] > 0.5, conv)
    np.testing.assert_allclose(out8[0], ref["px"][:, 0], atol=5e-3)
    np.testing.assert_allclose(out8[1], ref["px"][:, 1], atol=5e-3)
    np.testing.assert_allclose(out8[3][conv], ref["score"][conv], atol=1e-3)
    np.testing.assert_allclose(out8[4][conv], ref["gx"][conv], atol=2e-2)
    np.testing.assert_allclose(out8[5][conv], ref["gy"][conv], atol=2e-2)
    np.testing.assert_allclose(out8[6][conv], ref["chi2"][conv], rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(out8[7][conv], ref["mean_diff"][conv], atol=5e-3)


def test_align_plain_matches_jax_functions(problem):
    ref = _jax_reference(problem, problem["valid"])
    assert ref["converged"].sum() > 40                  # genuinely solvable
    assert not ref["converged"][[1, 2, 3]].any()        # adversarial rows fail
    before = dict(align_cuda.LAUNCHES)
    out8 = align_cuda.align_match(*_torch_args(problem, problem["valid"]), win=24, n_iter=10)
    assert align_cuda.LAUNCHES == before                # CPU tensors: the plain version
    assert out8.shape == (8, 64) and out8.dtype == torch.float32
    _check_packed(out8.numpy(), ref)
    # the pieces, called by name
    a = _torch_args(problem, problem["valid"])
    rm = align_mixed(a[0], a[1], a[2], a[3], n_iter=10, valid=a[4], windows=a[5],
                     anchors=(a[6], a[7]), img_hw=(a[8], a[9]))
    np.testing.assert_allclose(rm["cur_patch"].numpy()[ref["converged"]],
                               ref["cur_patch"][ref["converged"]], atol=5e-2)
    np.testing.assert_allclose(ncc(a[2][:, 1:9, 1:9], rm["cur_patch"]).numpy()[ref["converged"]],
                               ref["score"][ref["converged"]], atol=1e-3)
    gx, _ = sample_gradient_in_windows(a[5], a[6], a[7], rm["px"][:, 0], rm["px"][:, 1])
    np.testing.assert_allclose(gx.numpy()[ref["converged"]], ref["gx"][ref["converged"]],
                               atol=2e-2)


def test_align_plain_matches_jax_kernel(problem):
    from hso_tpu.ops.align_pallas import align_match_tpu

    j = jnp.asarray
    pb = problem
    with forced_interpret():
        ref8 = np.asarray(align_match_tpu(
            j(pb["is_edge"]), j(pb["direction"]), j(pb["ref_border"]), j(pb["px_init"]),
            j(pb["valid"]), j(pb["windows"]), j(pb["au"]), j(pb["av"]), j(pb["hs"]), j(pb["ws"]),
            win=24, n_iter=10))
    out8 = align_cuda.align_match_plain(*_torch_args(pb, pb["valid"]), win=24, n_iter=10).numpy()
    conv = ref8[2] > 0.5
    np.testing.assert_array_equal(out8[2] > 0.5, conv)
    np.testing.assert_allclose(out8[:2], ref8[:2], atol=5e-3)
    np.testing.assert_allclose(out8[3][conv], ref8[3][conv], atol=1e-3)
    np.testing.assert_allclose(out8[4:6][:, conv], ref8[4:6][:, conv], atol=2e-2)
    np.testing.assert_allclose(out8[6][conv], ref8[6][conv], rtol=1e-2, atol=1e-2)


def test_align_empty_mask_returns_px_init(problem):
    dead = np.zeros_like(problem["valid"])
    ref = _jax_reference(problem, dead)
    out8 = align_cuda.align_match(*_torch_args(problem, dead), win=24, n_iter=10).numpy()
    assert not ref["converged"].any() and not (out8[2] > 0.5).any()
    np.testing.assert_allclose(out8[:2].T, problem["px_init"], atol=1e-6)
    np.testing.assert_allclose(ref["px"], problem["px_init"], atol=1e-6)


def _map_problem(scene):
    T_cur = se3np.exp(np.array([0.03, -0.02, 0.015, 0.006, -0.008, 0.004]))
    pb = testing.track_problem(scene.cam, scene, T_cur, p_max=512)
    ar = np.arange(24)
    img = pb["img_prev"].astype(np.float32)
    av, au = pb["anchor"][:, 1], pb["anchor"][:, 0]
    pb["win"] = img[(av[:, None] + ar)[:, :, None], (au[:, None] + ar)[:, None, :]]
    pb["T_cur"] = T_cur.astype(np.float32)
    return pb


def test_select_candidates_cells_exact(scene):
    pb = _map_problem(scene)
    cam_j = JaxPinhole(320, 240, 200.0, 200.0, 160.0, 120.0)
    valid = pb["light"] >= 8
    prio = pb["light"] & 7
    kw = dict(cell=20, grid_h=12, grid_w=16)
    ref = jax.tree.map(np.asarray, jax_select(
        jnp.asarray(pb["pos_w"]), jnp.asarray(valid), jnp.asarray(prio), jnp.asarray(pb["T_cur"]),
        cam_j, **kw))
    out = select_candidates(t(pb["pos_w"]), t(valid), t(prio), t(pb["T_cur"]), scene.cam, **kw)
    assert ref["cell_valid"].sum() > 100 and ref["cell_valid2"].sum() > 20
    for k in ("cell_point", "cell_valid", "cell_point2", "cell_valid2", "n_projected"):
        np.testing.assert_array_equal(out[k].numpy(), ref[k], err_msg=k)
    np.testing.assert_allclose(out["cell_px"].numpy(), ref["cell_px"], atol=1e-4)
    np.testing.assert_allclose(out["cell_px2"].numpy(), ref["cell_px2"], atol=1e-4)


def test_match_points_end_to_end(scene):
    pb = _map_problem(scene)
    cam_j = JaxPinhole(320, 240, 200.0, 200.0, 160.0, 120.0)
    n = 160
    idx = np.arange(n)
    cols = pb["cols"][idx]
    cand = {
        "host_win": pb["win"][idx], "host_anchor": pb["anchor"][idx],
        "host_px": cols[:, 0:2], "host_f": cols[:, 2:5],
        "host_level": np.zeros(n, np.int32), "grad": cols[:, 8:10],
        "species": pb["species"][idx],
        "idist": (1.0 / np.linalg.norm(pb["pos_w"][idx], axis=-1)).astype(np.float32),
        "T_host_w": pb["kf_poses"][np.zeros(n, np.int64)],
        "exposure_host": np.ones(n, np.float32), "valid": np.arange(n) % 11 != 0,
    }
    data_t = build_frame_pyramids(pb["img_cur"], device="cpu")
    pyr_np = [p.numpy() for p in data_t["pyr"]]
    sob = lambda k: tuple(jnp.asarray(s.numpy()) for s in data_t[k])   # noqa: E731
    ref = jax.tree.map(np.asarray, jax_match_points(
        {k: jnp.asarray(v) for k, v in cand.items()}, tuple(jnp.asarray(p) for p in pyr_np),
        sob("sobel_x"), sob("sobel_y"), jnp.asarray(pb["T_cur"]), jnp.float32(1.0), cam_j))
    out = match_points({k: t(v) for k, v in cand.items()}, data_t["pyr"], data_t["sobel_x"],
                       data_t["sobel_y"], t(pb["T_cur"]), t(np.float32(1.0)), scene.cam)
    assert ref["success"].sum() > 100
    np.testing.assert_array_equal(out["success"].numpy(), ref["success"])
    np.testing.assert_array_equal(out["level"].numpy(), ref["level"])
    np.testing.assert_allclose(out["px"].numpy(), ref["px"], atol=1e-2)
    np.testing.assert_allclose(out["f_cur"].numpy(), ref["f_cur"], atol=1e-4)
    np.testing.assert_allclose(out["grad_cur"].numpy(), ref["grad_cur"], atol=1e-5)


def _split_rows(pb, edge):
    """The problem's rows of one kind (all corners or all edgelets)."""
    rows = np.nonzero(pb["is_edge"] == edge)[0]
    return {k: (v[rows] if isinstance(v, np.ndarray) and v.shape[:1] == pb["is_edge"].shape
                else v) for k, v in pb.items()}


@pytest.mark.parametrize("kind", ["2d", "1d"])
def test_align2d_align1d_match_jax(problem, kind):
    """The split alignments on prebuilt windows: px 5e-3, converged exact,
    chi2 1 %, mean_diff 5e-3, ``h_inv`` 1e-4 relative."""
    from hso_tpu.ops.align import align1d as jax_align1d, align2d as jax_align2d
    from hso_tpu_torch.ops.align import align1d, align2d

    pb = _split_rows(problem, kind == "1d")
    j = jnp.asarray
    kw_j = dict(n_iter=10, valid=j(pb["valid"]), windows=j(pb["windows"]),
                anchors=(j(pb["au"]), j(pb["av"])), img_hw=(j(pb["hs"]), j(pb["ws"])))
    kw_t = dict(n_iter=10, valid=t(pb["valid"]), windows=t(pb["windows"]),
                anchors=(t(pb["au"]), t(pb["av"])), img_hw=(t(pb["hs"]), t(pb["ws"])))
    if kind == "2d":
        ref = jax_align2d(None, j(pb["ref_border"]), j(pb["px_init"]), **kw_j)
        got = align2d(None, t(pb["ref_border"]), t(pb["px_init"]), **kw_t)
    else:
        ref = jax_align1d(None, j(pb["direction"]), j(pb["ref_border"]), j(pb["px_init"]), **kw_j)
        got = align1d(None, t(pb["direction"]), t(pb["ref_border"]), t(pb["px_init"]), **kw_t)
    ref = jax.tree.map(np.asarray, ref)
    got = {k: v.numpy() for k, v in got.items()}
    assert set(got) == set(ref)
    conv = ref["converged"]
    assert conv.sum() >= 0.5 * len(conv)
    np.testing.assert_array_equal(got["converged"], conv)
    np.testing.assert_allclose(got["px"], ref["px"], atol=5e-3)
    np.testing.assert_allclose(got["chi2"][conv], ref["chi2"][conv], rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got["mean_diff"][conv], ref["mean_diff"][conv], atol=5e-3)
    np.testing.assert_allclose(got["cur_patch"][conv], ref["cur_patch"][conv], atol=5e-2)
    if kind == "1d":
        np.testing.assert_allclose(got["h_inv"], ref["h_inv"], rtol=1e-4)


def test_align2d_cuts_its_own_windows(pyr, problem):
    """Given the search image instead of prebuilt windows, ``align2d`` cuts
    24-px windows around the initial estimates, as the JAX function does."""
    from hso_tpu.ops.align import align2d as jax_align2d
    from hso_tpu_torch.ops.align import align2d

    rows = np.nonzero((problem["level"] == 0) & ~problem["is_edge"])[0]
    ref = jax.tree.map(np.asarray, jax_align2d(
        jnp.asarray(pyr[0]), jnp.asarray(problem["ref_border"][rows]),
        jnp.asarray(problem["px_init"][rows]), n_iter=10,
        valid=jnp.asarray(problem["valid"][rows])))
    got = align2d(t(pyr[0]), t(problem["ref_border"][rows]), t(problem["px_init"][rows]),
                  n_iter=10, valid=t(problem["valid"][rows]))
    assert len(rows) > 5 and ref["converged"].sum() > 3
    np.testing.assert_array_equal(got["converged"].numpy(), ref["converged"])
    np.testing.assert_allclose(got["px"].numpy(), ref["px"], atol=5e-3)


def _align_loop_that_breaks(is_edge, direction, ref_border, px_init, valid, windows,
                            au, av, hs, ws, win, n_iter):
    """The alignment as a loop that STOPS: every row on its own, left at the
    top of the iteration that finds its patch outside the image or its window
    (or its position not finite), or right after the update that was small
    enough to converge; a row with ``valid`` false never enters.  Written from
    the pieces of ``ops/align`` and the solver the row's kind needs, nothing
    else.  Returns the packed (8, S) result and, per row, the number of
    updates it took."""
    from hso_tpu_torch.math.linalg_small import inv2x2, inv3x3
    from hso_tpu_torch.ops import align as al

    n = ref_border.shape[0]
    ref, dx, dy = al._template_grads(ref_border)
    ones = torch.ones_like(dx)
    d = direction / torch.clamp_min(torch.linalg.norm(direction, dim=-1, keepdim=True), 1e-9)
    jd = dx * d[:, None, None, 0] + dy * d[:, None, None, 1]
    wgt2 = torch.sqrt(250.0 / (250.0 + dx * dx + dy * dy))
    wgt1 = torch.sqrt(250.0 / (250.0 + jd * jd))
    j3 = torch.stack([dx, dy, ones], dim=-1)
    j2 = torch.stack([jd, ones], dim=-1)
    H3 = torch.sum(j3[..., :, None] * j3[..., None, :] * wgt2[..., None, None], dim=(1, 2))
    H2 = torch.sum(j2[..., :, None] * j2[..., None, :] * wgt1[..., None, None], dim=(1, 2))
    Hinv3 = inv3x3(H3 * (torch.eye(3) * 1e-3 + 1.0))
    Hinv2 = inv2x2(H2 * (torch.eye(2) * 1e-3 + 1.0))
    auf, avf = au.to(torch.float32), av.to(torch.float32)

    u, v = px_init[:, 0].clone(), px_init[:, 1].clone()
    mean, chi2 = torch.zeros(n), torch.zeros(n)
    conv = torch.zeros(n, dtype=torch.bool)
    updates = torch.zeros(n, dtype=torch.int32)
    for r in range(n):
        if not bool(valid[r]):
            continue
        row = slice(r, r + 1)
        edge = bool(is_edge[r])
        jac, wgt, Hinv = (j2, wgt1, Hinv2) if edge else (j3, wgt2, Hinv3)
        for _ in range(n_iter):
            patch, rel_u, rel_v = al._sample(windows[row], auf[row], avf[row], u[row], v[row])
            inb = al._in_image(u[row], v[row], hs[row], ws[row]) \
                & al._in_window(rel_u, win) & al._in_window(rel_v, win)
            if not bool(inb & torch.isfinite(u[row]) & torch.isfinite(v[row])):
                break                                   # left: the state stays as it is
            res = patch - ref[row] + mean[row, None, None]
            chi2[row] = torch.sum(res * res * wgt[row], dim=(1, 2))
            jres = -torch.sum((res * wgt[row])[..., None] * jac[row], dim=(1, 2))
            upd = torch.sum(Hinv[row] * jres[:, None, :], dim=-1)[0]
            if edge:
                u[r], v[r], mean[r] = u[r] + upd[0] * d[r, 0], v[r] + upd[0] * d[r, 1], \
                    mean[r] + upd[1]
                small = bool(upd[0] ** 2 < 0.01 * 0.01)
            else:
                u[r], v[r], mean[r] = u[r] + upd[0], v[r] + upd[1], mean[r] + upd[2]
                small = bool(upd[0] ** 2 + upd[1] ** 2 < 0.03 * 0.03)
            updates[r] += 1
            if small:
                conv[r] = True
                break                                   # converged: nothing moves from here on
    conv = conv & (chi2 <= 1000.0 * 64)
    final_patch, _, _ = al._sample(windows, auf, avf, u, v)
    score = ncc(ref_border[:, 1:9, 1:9], final_patch)
    gx, gy = sample_gradient_in_windows(windows, au, av, u, v)
    return torch.stack([u, v, conv.to(torch.float32), score, gx, gy, chi2, mean], dim=0), updates


@pytest.mark.parametrize("mask", ["as given", "all valid", "none valid"])
def test_align_plain_keeps_its_result_once_a_row_is_inactive(problem, mask):
    """A loop that leaves a candidate once it is inactive (converged, left its
    window or the image, or never valid) returns the bits of the plain
    version, which runs all ``n_iter`` iterations under the mask; and it
    leaves every row after the number of updates at which the plain version's
    result stops changing."""
    import chip_smoke as cs

    valid = {"as given": problem["valid"], "all valid": np.ones_like(problem["valid"]),
             "none valid": np.zeros_like(problem["valid"])}[mask]
    args = _torch_args(problem, valid)
    full = align_cuda.align_match_plain(*args, win=24, n_iter=10).numpy().view(np.int32)
    broke, updates = _align_loop_that_breaks(*args, win=24, n_iter=10)
    np.testing.assert_array_equal(broke.numpy().view(np.int32), full)
    its = cs.align_iterations(*args, win=24, n_iter=10).numpy()
    np.testing.assert_array_equal(updates.numpy(), its)
    for k in range(11):
        out_k = align_cuda.align_match_plain(*args, win=24, n_iter=k).numpy().view(np.int32)
        done = its <= k                     # a loop that breaks has left these rows
        np.testing.assert_array_equal(out_k[:, done], full[:, done])
        moving = its > k
        assert (out_k[:, moving] != full[:, moving]).any(axis=0).all()
    if mask == "none valid":
        assert (its == 0).all()
    else:
        assert its[2 if mask == "as given" else 1] == 0         # dead slot / patch off the image
        assert 0 < np.median(its[its > 0]) < 10 and its.max() <= 10
        # rows stop for every reason: some converge, some leave, some run out
        conv = full.view(np.float32)[2] > 0.5
        assert conv.any() and (~conv & (its < 10) & valid).any()


@pytest.mark.parametrize("shape, plan", [
    ((336, 24), (4, 128, 9216)),            # the matcher's passes
    ((1024, 40), (4, 128, 25600)),          # the sweep: 8 blocks = 32 warps in 227 KB
    ((3, 24), (3, 96, 6912)),               # no more warps than candidates
    ((64, 25), (4, 128, 10048)),            # 625 floats rounded up to 16 bytes
    ((64, 150), (2, 64, 180000)),           # three such windows do not fit 227 KB
])
def test_align_launch_plan(shape, plan):
    assert align_cuda.align_launch_plan(*shape) == plan
    assert align_cuda.align_launch_plan(*shape) == plan         # a pure function


def test_align_launch_plan_raises_beyond_shared_memory():
    assert align_cuda.align_launch_plan(4, 240)[2] <= align_cuda.SMEM_MAX
    with pytest.raises(ValueError):
        align_cuda.align_launch_plan(4, 300)

"""Port ↔ JAX parity of the epipolar ZMNCC line search (CPU).

The plain version of kernel K6 (``zmncc_line_scores_plain``) and the search
around it (``epipolar_zmncc_search``) against the JAX function, run both
through its XLA branch and through the Pallas kernel ``zmncc_line_scores_tpu``
in interpret mode; ``triangulate_depth`` against JAX.

Tolerances: ``n_line``, ``ok`` and the set of finite rows exact; scores 2e-4
(the 64-term correlation and the box sums are taken in different orders by
the three implementations, and ``Σt² − (Σt)²/64`` cancels); ``px_best`` 1e-4 on
``ok`` rows (the same step index gives the same pixel up to the rounding of
``start + dir·k``); triangulated depth 1e-6 relative.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hso_tpu.ops import window_pallas
from hso_tpu.ops.epipolar import (epipolar_zmncc_search as jax_search,
                                  pack_level_windows as jax_pack,
                                  triangulate_depth as jax_triangulate)
from hso_tpu.ops.epipolar_pallas import zmncc_line_scores_tpu
from hso_tpu.ops.gatherless import bilinear_grid as jax_bilinear_grid
from hso_tpu_torch import testing
from hso_tpu_torch.cameras import PinholeCamera
from hso_tpu_torch.image.pyramid import build_frame_pyramids
from hso_tpu_torch.math import se3np
from hso_tpu_torch.ops import epipolar_cuda
from hso_tpu_torch.ops.epipolar import (AMBIGUITY_RATIO, EW, MAX_EPL, MIN_EPL, PATCH,
                                        epipolar_zmncc_search, pack_level_windows,
                                        triangulate_depth)
from hso_tpu_torch.utils.synthetic import PlaneScene

torch.set_num_threads(1)

t = torch.as_tensor
N_STEPS = 40


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
def pyr():
    cam = PinholeCamera(640, 480, 400.0, 400.0, 320.0, 240.0)
    scene = PlaneScene(cam, z0=2.0, extent=2.5, seed=3, tex_size=1024)
    return [p.numpy() for p in build_frame_pyramids(scene.render(), device="cpu")["pyr"][:3]]


@pytest.fixture(scope="module")
def problem(pyr):
    """S=48 segments on 48-px windows with the adversarial rows; windows by
    both packers (they must be equal), templates by the JAX sampler."""
    pb = testing.epipolar_problem([p.shape for p in pyr], s=48, seed=7)
    j = jnp.asarray
    win_j, anc_j, hw_j = jax_pack(tuple(j(p) for p in pyr), j(pb["level"]),
                                  j(pb["center"][:, 0]), j(pb["center"][:, 1]), 48, 3)
    win_t, anc_t, hw_t = pack_level_windows(tuple(t(p) for p in pyr), t(pb["level"]),
                                            t(pb["center"][:, 0]), t(pb["center"][:, 1]), 48, 3)
    np.testing.assert_array_equal(win_t.numpy(), np.asarray(win_j))
    for a, b in zip(anc_t + hw_t, anc_j + hw_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ref_patch = jax_bilinear_grid(win_j, j(pb["center"][:, 0]) - 4.0 - anc_j[0],
                                  j(pb["center"][:, 1]) - 4.0 - anc_j[1], 8)
    pb.update(windows=np.array(win_j), au=np.array(anc_j[0]), av=np.array(anc_j[1]),
              hs=np.array(hw_j[0]), ws=np.array(hw_j[1]), ref_patch=np.array(ref_patch))
    return pb


def _jax_search(pb):
    j = jnp.asarray
    return jax.tree.map(np.asarray, jax_search(
        j(pb["windows"]), (j(pb["au"]), j(pb["av"])), (j(pb["hs"]), j(pb["ws"])),
        j(pb["ref_patch"]), j(pb["px_far"]), j(pb["px_close"]), j(pb["valid"]), n_steps=N_STEPS))


@pytest.fixture(scope="module")
def jax_xla(problem):
    return _jax_search(problem)


@pytest.fixture(scope="module")
def jax_interpret(problem):
    with forced_interpret():
        return _jax_search(problem)


@pytest.fixture(scope="module")
def torch_out(problem):
    pb = problem
    out = epipolar_zmncc_search(
        t(pb["windows"]), (t(pb["au"]), t(pb["av"])), (t(pb["hs"]), t(pb["ws"])),
        t(pb["ref_patch"]), t(pb["px_far"]), t(pb["px_close"]), t(pb["valid"]), n_steps=N_STEPS)
    return {k: v.numpy() for k, v in out.items()}


def test_constants():
    from hso_tpu.ops import epipolar as ref

    assert (PATCH, EW, MAX_EPL, MIN_EPL, AMBIGUITY_RATIO) == (
        ref.PATCH, ref.EW, ref.MAX_EPL, ref.MIN_EPL, ref.AMBIGUITY_RATIO)


@pytest.mark.parametrize("which", ["xla", "interpret"])
def test_search_matches_jax(which, torch_out, jax_xla, jax_interpret):
    ref = jax_xla if which == "xla" else jax_interpret
    out = torch_out
    assert set(out) == set(ref)
    np.testing.assert_array_equal(out["n_line"], ref["n_line"])
    assert out["n_line"].dtype == ref["n_line"].dtype
    np.testing.assert_allclose(out["epl_dir"], ref["epl_dir"], atol=1e-6)
    finite = np.isfinite(ref["score_best"])
    np.testing.assert_array_equal(np.isfinite(out["score_best"]), finite)
    np.testing.assert_array_equal(np.isneginf(out["score_best"]), np.isneginf(ref["score_best"]))
    np.testing.assert_allclose(out["score_best"][finite], ref["score_best"][finite], atol=2e-4)
    f2 = np.isfinite(ref["score_second"])
    np.testing.assert_array_equal(np.isfinite(out["score_second"]), f2)
    np.testing.assert_allclose(out["score_second"][f2], ref["score_second"][f2], atol=2e-4)
    np.testing.assert_array_equal(out["ok"], ref["ok"])
    okm = ref["ok"]
    assert okm.sum() > 20 and not okm[2]
    np.testing.assert_allclose(out["px_best"][okm], ref["px_best"][okm], atol=1e-4)


def test_line_scores_match_the_tpu_kernel_interpreted():
    """The kernel's own interface on noise windows with the adversarial rows:
    low-contrast window, segment outside the window, segment ending on the last map
    column, window at the image corner, zero direction."""
    case = testing.line_score_cases(s=24, ew=48, n_steps=N_STEPS, seed=0)
    order = ("windows", "ref_patch", "su0", "sv0", "dir_u", "dir_v", "n_line", "au", "av",
             "hs", "ws")
    with forced_interpret():
        ref = [np.asarray(x) for x in zmncc_line_scores_tpu(
            *[jnp.asarray(case[k]) for k in order], n_steps=N_STEPS)]
    got = [x.numpy() for x in epipolar_cuda.zmncc_line_scores(
        *[t(case[k]) for k in order], N_STEPS)]
    assert got[2].dtype == np.int32 and ref[2].dtype == np.int32
    finite = np.isfinite(ref[0])
    assert finite.sum() >= 18
    np.testing.assert_array_equal(np.isfinite(got[0]), finite)
    np.testing.assert_allclose(got[0][finite], ref[0][finite], atol=2e-4)
    f2 = np.isfinite(ref[1])
    np.testing.assert_array_equal(np.isfinite(got[1]), f2)
    np.testing.assert_allclose(got[1][f2], ref[1][f2], atol=2e-4)
    # the step index: exact wherever the best beats the runner-up of the
    # neighbouring steps by more than the score tolerance
    np.testing.assert_array_equal(got[2][~finite], ref[2][~finite])
    assert (got[2] == ref[2]).mean() >= 0.9
    # row 1: every step masked -> (-inf, -inf, 0) from both
    assert np.isneginf(got[0][1]) and np.isneginf(got[1][1]) and got[2][1] == 0
    assert np.isneginf(ref[0][1]) and ref[2][1] == 0
    # row 0: the low-contrast window still finds its template
    assert got[0][0] > 0.99 and ref[0][0] > 0.99
    # row 2: the last step sits exactly on the last map column and counts
    assert np.isfinite(got[0][2])


def test_non_finite_window_poisons_the_row_and_only_it():
    case = testing.line_score_cases(s=8, ew=40, n_steps=N_STEPS, seed=1)
    order = ("windows", "ref_patch", "su0", "sv0", "dir_u", "dir_v", "n_line", "au", "av",
             "hs", "ws")
    clean = [x.numpy() for x in epipolar_cuda.zmncc_line_scores_plain(
        *[t(case[k]) for k in order], N_STEPS)]
    case["windows"][5, 0, 0] = np.inf
    got = [x.numpy() for x in epipolar_cuda.zmncc_line_scores_plain(
        *[t(case[k]) for k in order], N_STEPS)]
    assert np.isfinite(clean[0][5]) and np.isnan(got[0][5]) and np.isnan(got[1][5])
    keep = np.arange(8) != 5
    for a, b in zip(got, clean):
        np.testing.assert_array_equal(a[keep], b[keep])


def test_flat_window_score_is_a_rounding_residue_on_every_side():
    """On a window of exactly constant grey level ``corr − mean·Σt`` is a
    rounding residue that the ``1e-12`` guard turns into a score of either
    exactly 0 or more than 1e6 in magnitude, depending on the order of the
    64-term sum: the JAX convolution, the JAX kernel (interpreted) and the port
    each give their own such value.  Nothing here is a correlation, so the
    parity tests use low-contrast windows, never flat ones."""
    case = testing.line_score_cases(s=8, ew=48, n_steps=N_STEPS, seed=0)
    case["windows"][0] = 77.0
    order = ("windows", "ref_patch", "su0", "sv0", "dir_u", "dir_v", "n_line", "au", "av",
             "hs", "ws")
    port = float(epipolar_cuda.zmncc_line_scores_plain(*[t(case[k]) for k in order],
                                                       N_STEPS)[0][0])
    with forced_interpret():
        kernel = float(zmncc_line_scores_tpu(*[jnp.asarray(case[k]) for k in order],
                                             n_steps=N_STEPS)[0][0])
    from hso_tpu.ops.epipolar import _box_sums, _depthwise_corr

    w, r = jnp.asarray(case["windows"][:1]), jnp.asarray(case["ref_patch"][:1])
    st, st2 = _box_sums(w, 8), _box_sums(w * w, 8)
    rm = jnp.mean(r, axis=(1, 2))
    rd = jnp.sum((r - rm[:, None, None]) ** 2, axis=(1, 2))
    zm = (_depthwise_corr(w, r) - rm[:, None, None] * st) / (
        jnp.sqrt(rd[:, None, None] * jnp.maximum(st2 - st * st / 64.0, 0.0)) + 1e-12)
    xla = float(jnp.max(jnp.abs(zm)))
    for value in (port, kernel, xla):
        assert np.isfinite(value) and (value == 0.0 or abs(value) > 1e6), (port, kernel, xla)
    assert abs(port) > 1e6 and abs(kernel) > 1e6


def test_dispatcher_and_counter_on_cpu():
    case = testing.line_score_cases(s=6, ew=40, n_steps=N_STEPS, seed=2)
    order = ("windows", "ref_patch", "su0", "sv0", "dir_u", "dir_v", "n_line", "au", "av",
             "hs", "ws")
    args = [t(case[k]) for k in order]
    before = epipolar_cuda.LAUNCHES["zmncc_line_scores"]
    a = epipolar_cuda.zmncc_line_scores(*args, N_STEPS)
    b = epipolar_cuda.zmncc_line_scores_plain(*args, N_STEPS)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert epipolar_cuda.LAUNCHES["zmncc_line_scores"] == before    # no launch on the CPU
    with pytest.raises(ValueError):
        epipolar_cuda.zmncc_line_scores_cuda(*args, N_STEPS)        # CPU tensors are refused


def test_score_map_is_a_true_zmncc():
    """The map's entry at the template's own position is 1 for any gain and
    offset of the template."""
    case = testing.line_score_cases(s=6, ew=40, n_steps=N_STEPS, seed=3)
    zm = epipolar_cuda.zmncc_score_map(t(case["windows"]), t(case["ref_patch"])).numpy()
    assert zm.shape == (6, 33, 33)
    peak = zm.reshape(6, -1).max(axis=1)
    np.testing.assert_allclose(peak, 1.0, atol=1e-4)
    assert np.abs(zm).max() <= 1.0 + 1e-4


def test_triangulate_depth_matches_jax():
    rs = np.random.RandomState(4)
    n = 64
    T = np.stack([se3np.exp(np.r_[rs.uniform(-0.3, 0.3, 3), rs.uniform(-0.05, 0.05, 3)])
                  for _ in range(n)]).astype(np.float32)
    f_ref = rs.normal(0, 0.3, (n, 3)).astype(np.float32)
    f_ref[:, 2] = 1.0
    f_ref /= np.linalg.norm(f_ref, axis=-1, keepdims=True)
    depth = rs.uniform(1.0, 5.0, n).astype(np.float32)
    p_cur = np.einsum("nij,nj->ni", T[:, :, :3], f_ref * depth[:, None]) + T[:, :, 3]
    f_cur = (p_cur / np.linalg.norm(p_cur, axis=-1, keepdims=True)).astype(np.float32)
    T[0, :, 3] = 0.0                                   # no baseline: singular system
    f_cur[0] = T[0, :, :3] @ f_ref[0]
    z_ref, ok_ref = (np.asarray(x) for x in jax_triangulate(
        jnp.asarray(T), jnp.asarray(f_ref), jnp.asarray(f_cur)))
    z, ok = (x.numpy() for x in triangulate_depth(t(T), t(f_ref), t(f_cur)))
    np.testing.assert_array_equal(ok, ok_ref)
    assert not ok[0] and ok[1:].all()
    np.testing.assert_allclose(z[ok], z_ref[ok], rtol=1e-6)
    np.testing.assert_allclose(z[1:], depth[1:], rtol=1e-3)


ORDER = ("windows", "ref_patch", "su0", "sv0", "dir_u", "dir_v", "n_line", "au", "av", "hs", "ws")
#: rows of `contract_case` and what each pins (row: reason it has no step inside / what
#: poisons it); every such row also carries a NaN in its window
NO_STEP_ROWS = {"segment outside the window": 6, "patch outside the image": 7,
                "non-finite geometry": 8, "negative step count": 9}
POISONED_ROWS = {"inf off the line": 10, "nan off the line": 11, "nan on the line": 12,
                 "overflowing entry off the line": 13, "inf in the template": 14}


@pytest.fixture(scope="module")
def contract_case():
    """EW 40, S = 24: the rows a kernel that leaves early and scores only the
    entries on the line must still get right, through the plain version and
    through the JAX kernel (interpreted)."""
    case = testing.line_score_cases(s=24, ew=40, n_steps=N_STEPS, seed=5)
    for row in list(NO_STEP_ROWS.values()) + list(POISONED_ROWS.values()) + [15]:
        # a horizontal segment through the window's middle: map rows 20 and 21,
        # map columns 12..23, window pixels (12..30, 20..28)
        case["su0"][row], case["sv0"][row] = 12.0, 20.3
        case["dir_u"][row], case["dir_v"][row], case["n_line"][row] = 1.0, 0.0, 10
    r = NO_STEP_ROWS
    case["su0"][r["segment outside the window"]] = -60.0
    case["dir_u"][r["segment outside the window"]] = -1.0
    case["hs"][r["patch outside the image"]] = 10
    case["ws"][r["patch outside the image"]] = 10
    case["su0"][r["non-finite geometry"]] = np.nan
    case["n_line"][r["negative step count"]] = -1
    for row in r.values():
        case["windows"][row, 22, 15] = np.nan
    p = POISONED_ROWS
    case["windows"][p["inf off the line"], 0, 0] = np.inf
    case["windows"][p["nan off the line"], 39, 39] = np.nan
    case["windows"][p["nan on the line"], 24, 20] = np.nan
    case["windows"][p["overflowing entry off the line"], 2, 35] = 1e20
    case["ref_patch"][p["inf in the template"], 3, 3] = np.inf
    case["windows"][15, 0, 0] = 1e15            # huge but harmless: off the line, no overflow
    with forced_interpret():
        ref = [np.asarray(x) for x in zmncc_line_scores_tpu(
            *[jnp.asarray(case[k]) for k in ORDER], n_steps=N_STEPS)]
    got = [x.numpy() for x in epipolar_cuda.zmncc_line_scores_plain(
        *[t(case[k]) for k in ORDER], N_STEPS)]
    return got, ref


@pytest.mark.parametrize("why", list(NO_STEP_ROWS))
def test_row_without_a_step_inside(contract_case, why):
    """(−inf, −inf, 0) from the plain version and from the JAX kernel, whatever
    the row's window holds (here a NaN in the middle of it)."""
    row = NO_STEP_ROWS[why]
    for best, second, k_best in contract_case:
        assert np.isneginf(best[row]) and np.isneginf(second[row]) and k_best[row] == 0


@pytest.mark.parametrize("what", list(POISONED_ROWS))
def test_non_finite_entry_poisons_its_row_on_and_off_the_line(contract_case, what):
    """One non-finite map entry anywhere, read by the line or not, turns the
    row's best score into NaN (a non-finite best is gated out by the caller),
    in the plain version and in the JAX kernel alike."""
    row = POISONED_ROWS[what]
    got, ref = contract_case
    assert np.isnan(got[0][row]) and np.isnan(got[1][row])
    assert not np.isfinite(ref[0][row])
    assert got[2][row] == 0                 # the port: the first step that is inside


def test_contract_case_leaves_the_other_rows_alone(contract_case):
    got, ref = contract_case
    special = sorted(list(NO_STEP_ROWS.values()) + list(POISONED_ROWS.values()))
    keep = np.setdiff1d(np.arange(24), special + [1])   # row 1: outside by construction
    assert np.isfinite(got[0][keep]).all() and np.isfinite(ref[0][keep]).all()
    np.testing.assert_allclose(got[0][keep], ref[0][keep], atol=2e-4)
    assert np.isfinite(got[0][15])              # 1e15 off the line: finite, not poison


@pytest.mark.parametrize("shape, plan", [
    ((1024, 40, 40), (2, 128, 14464)),          # the sweep: 1808 floats a seed
    ((256, 48, 40), (2, 128, 20096)),
    ((1, 40, 40), (1, 64, 7232)),               # no more seeds than there are
    ((1024, 41, 40), (2, 128, 15136)),          # rounded up to 16 bytes a seed
    ((16, 200, 40), (1, 64, 160832)),           # two such seeds do not fit 227 KB
])
def test_zmncc_launch_plan(shape, plan):
    assert epipolar_cuda.zmncc_launch_plan(*shape) == plan
    assert epipolar_cuda.zmncc_launch_plan(*shape) == plan      # a pure function


def test_zmncc_launch_plan_raises_beyond_shared_memory():
    assert epipolar_cuda.zmncc_launch_plan(4, 236, 40)[2] <= epipolar_cuda.SMEM_MAX
    with pytest.raises(ValueError):
        epipolar_cuda.zmncc_launch_plan(4, 300, 40)

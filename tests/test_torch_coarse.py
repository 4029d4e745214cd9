"""Port ↔ JAX parity of the coarse tracker (CPU).

One level: the plain version of kernel K3 against the JAX level loop
(``coarse_level_ic_tpu`` run in Pallas interpret mode, as the JAX package's
own parity test runs it), at the four level shapes of the main path.  Whole
track: IC and FC against ``make_coarse_tracker``.  The launch plan of K3
(which block of the cluster owns which features, and whether their windows
fit its shared memory) is a pure function of the shape and is held here.  Tolerances: T < 1e-3 (|log| of the relative
transform), exposure ratio < 1e-3, energy within 5 % — two float32
implementations summing ~10^3 residuals in different orders through up to 30
accept/reject steps agree on the converged state, not on the iterate path.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hso_tpu.cameras import PinholeCamera as JaxPinhole
from hso_tpu.image.pyramid import build_frame_pyramids as jax_pyramids
from hso_tpu.ops import window_pallas
from hso_tpu.track.coarse_tracker import make_coarse_tracker as jax_make_tracker
from hso_tpu_torch import testing
from hso_tpu_torch.cameras import PinholeCamera
from hso_tpu_torch.image.pyramid import build_frame_pyramids
from hso_tpu_torch.math import se3np
from hso_tpu_torch.ops.patterns import PATTERN_PADDING, PATTERNS
from hso_tpu_torch.track import coarse_cuda
from hso_tpu_torch.track.coarse_tracker import make_coarse_tracker
from hso_tpu_torch.utils.synthetic import PlaneScene

torch.set_num_threads(1)

T_GT = se3np.exp(np.array([0.03, -0.02, 0.015, 0.006, -0.008, 0.004]))
N_MAX = 96


@contextlib.contextmanager
def forced_interpret():
    """Route the JAX package's Pallas call sites through the interpreter."""
    window_pallas.force_interpret(True)
    jax.clear_caches()
    try:
        yield
    finally:
        window_pallas.force_interpret(False)
        jax.clear_caches()


@pytest.fixture(scope="module")
def problem():
    cam = PinholeCamera(320, 240, 200.0, 200.0, 160.0, 120.0)
    scene = PlaneScene(cam, z0=2.0, extent=2.5, seed=3, tex_size=1024)
    ref_img = scene.render()
    cur_img = scene.render(T_GT, exposure=0.97)
    px, f, dist = scene.grid_features(step=28, border=28)
    assert len(px) <= N_MAX
    px_p, f_p, d_p = testing.pad_features(px, f, dist, N_MAX)
    return dict(cam=cam, ref_img=ref_img, cur_img=cur_img, px=px_p, f=f_p, dist=d_p,
                n_live=len(px))


def _se3_dist(Ta, Tb):
    return np.linalg.norm(se3np.log(se3np.mul(np.asarray(Ta, np.float64),
                                              se3np.inv(np.asarray(Tb, np.float64)))))


@pytest.mark.parametrize("inverse", [True, False], ids=["ic", "fc"])
def test_track_matches_jax(problem, inverse):
    p = problem
    cam_j = JaxPinhole(320, 240, 200.0, 200.0, 160.0, 120.0)
    T0 = se3np.identity().astype(np.float32)
    ref_pyr_j = jax_pyramids(jnp.asarray(p["ref_img"]))["pyr"]
    cur_pyr_j = jax_pyramids(jnp.asarray(p["cur_img"]))["pyr"]
    ref = jax.tree.map(np.asarray, jax_make_tracker(cam_j, max_level=3, inverse=inverse)(
        ref_pyr_j, cur_pyr_j, p["px"], p["f"], p["dist"], T0, 1.0))

    track = make_coarse_tracker(p["cam"], max_level=3, inverse=inverse, device="cpu")
    before = dict(coarse_cuda.LAUNCHES)
    out = track(build_frame_pyramids(p["ref_img"], device="cpu")["pyr"],
                build_frame_pyramids(p["cur_img"], device="cpu")["pyr"],
                p["px"], p["f"], p["dist"], T0, 1.0)
    assert coarse_cuda.LAUNCHES == before          # CPU tensors: the plain version

    for r in (ref["T_cur_ref"], out["T_cur_ref"].numpy()):
        # both solve the problem (the coarse track stops at level 1 of a
        # 320x240 image, so its own accuracy is a few 1e-3)
        assert _se3_dist(r, T_GT) < 1.5e-2
    assert _se3_dist(out["T_cur_ref"].numpy(), ref["T_cur_ref"]) < 1e-3
    assert abs(float(out["exposure_ratio"]) - float(ref["exposure_ratio"])) < 1e-3
    assert abs(float(out["exposure_ratio"]) - 0.97) < 2e-2
    assert int(out["n_tracked"]) == int(ref["n_tracked"])
    np.testing.assert_allclose(float(out["energy"]), float(ref["energy"]), rtol=0.05)
    assert out["n_iters"].shape == (3,) and out["n_iters"].dtype == torch.int32


def _level_inputs(problem, level=2, pat_idx=3, is_top=False):
    """Inputs of one IC level built with numpy from the two images: windows
    by slicing, reference patches and template Jacobians at integer pixels.
    ``pat_idx`` picks the pattern (and with it P and the grid edge G)."""
    p = problem
    cam = p["cam"]
    pattern = tuple(map(tuple, PATTERNS[pat_idx]))
    radius = PATTERN_PADDING[pat_idx]
    g, c = 2 * radius + 3, radius + 1
    scale = 1.0 / (1 << level)
    ref = build_frame_pyramids(p["ref_img"], device="cpu")["pyr"][level].numpy()
    cur = build_frame_pyramids(p["cur_img"], device="cpu")["pyr"][level].numpy()
    h, w = cur.shape
    n = N_MAX
    xyz = (p["f"] * p["dist"][:, None]).astype(np.float32)
    u = np.floor(p["px"][:, 0] * scale)            # integer level pixels: the
    v = np.floor(p["px"][:, 1] * scale)            # reference patch is a slice
    vis = (p["dist"] > 0) & (u - c >= 0) & (v - c >= 0) & (u + c < w) & (v + c < h)
    ui = np.where(vis, u, c).astype(np.int64)
    vi = np.where(vis, v, c).astype(np.int64)
    dx = np.array([d[0] for d in pattern])
    dy = np.array([d[1] for d in pattern])
    yy, xx = vi[:, None] + dy, ui[:, None] + dx
    gx = 0.5 * (ref[yy, xx + 1] - ref[yy, xx - 1])
    gy = 0.5 * (ref[yy + 1, xx] - ref[yy - 1, xx])
    ref_patch = ref[yy, xx].astype(np.float32)
    # the features sit at integer level pixels: move the 3-D points there
    fxl, fyl, cxl, cyl = cam.fx * scale, cam.fy * scale, cam.cx * scale, cam.cy * scale
    z = np.where(vis, xyz[:, 2], 1.0)
    xyz = np.stack([(ui - cxl) / fxl * z, (vi - cyl) / fyl * z, z], -1).astype(np.float32)
    zi = 1.0 / z
    X, Y = xyz[:, 0], xyz[:, 1]
    zero = np.zeros_like(zi)
    r0 = np.stack([-zi, zero, X * zi**2, X * Y * zi**2, -(1 + X * X * zi**2), Y * zi], -1)
    r1 = np.stack([zero, -zi, Y * zi**2, 1 + Y * Y * zi**2, -X * Y * zi**2, -X * zi], -1)
    j_ic = (gx[..., None] * (fxl * r0[:, None, :]) + gy[..., None] * (fyl * r1[:, None, :]))
    au = np.clip(ui - (24 - g) // 2 - g // 2, 0, w - 24).astype(np.int32)
    av = np.clip(vi - (24 - g) // 2 - g // 2, 0, h - 24).astype(np.int32)
    ar = np.arange(24)
    w_cur = cur[(av[:, None] + ar)[:, :, None], (au[:, None] + ar)[:, None, :]].astype(np.float32)
    # initial pose: the ground truth perturbed, so the level has work to do
    T0 = se3np.mul(se3np.exp(np.array([0.004, -0.003, 0.002, 0.001, -0.001, 0.0005])), T_GT)
    assert n == len(au)
    return dict(w_cur=w_cur, ref_patch=ref_patch, j_ic=j_ic.astype(np.float32), xyz=xyz, au=au,
                av=av, vis=vis, T0=T0.astype(np.float32), a0=np.float32(0.95),
                huber=np.float32(9.0), cutoff=np.float32(40.0),
                static=dict(g=g, center=c, pattern=pattern, n_iter=30, is_top=is_top,
                            border=radius + 1, h_img=h, w_img=w),
                intr=(float(fxl), float(fyl), float(cxl), float(cyl)))


#: the four level shapes of the main path (``PATTERNS[max_level - level + 2]``
#: at levels 4, 3, 2, 1 of a 640x480 frame: P = 9, 13, 13, 21 with G = 5, 7, 7,
#: 9, the coarsest with the top level's energy), laid on the levels this
#: 320x240 scene has features on: (id, level here, pattern index, is_top)
LEVEL_SHAPES = [("level4-P9-top", 3, 2, True), ("level3-P13", 2, 3, False),
                ("level2-P13", 1, 4, False), ("level1-P21", 1, 5, False)]


@pytest.mark.parametrize("empty", [False, True], ids=["live", "empty-mask"])
@pytest.mark.parametrize("shape", LEVEL_SHAPES, ids=[s[0] for s in LEVEL_SHAPES])
def test_level_plain_matches_jax_level_loop(problem, shape, empty):
    """K3's plain version against the JAX kernel of the same level."""
    from hso_tpu.track.coarse_pallas import coarse_level_ic_tpu

    _, level, pat_idx, is_top = shape
    q = _level_inputs(problem, level=level, pat_idx=pat_idx, is_top=is_top)
    p_want, g_want = {2: (9, 5), 3: (13, 7), 4: (13, 7), 5: (21, 9)}[pat_idx]
    assert (len(q["static"]["pattern"]), q["static"]["g"]) == (p_want, g_want)
    vis = np.zeros_like(q["vis"]) if empty else q["vis"]
    with forced_interpret():
        ref = coarse_level_ic_tpu(
            jnp.asarray(q["w_cur"]), jnp.asarray(q["ref_patch"]), jnp.asarray(q["j_ic"]),
            jnp.asarray(q["xyz"]), jnp.asarray(q["au"]), jnp.asarray(q["av"]), jnp.asarray(vis),
            jnp.asarray(q["T0"]), jnp.asarray(q["a0"]), jnp.asarray(q["huber"]),
            jnp.asarray(q["cutoff"]), *q["intr"], **q["static"])
        ref = [np.asarray(r) for r in ref]
    t = torch.as_tensor
    out = coarse_cuda.coarse_level_ic(
        t(q["w_cur"]), t(q["ref_patch"]), t(q["j_ic"]), t(q["xyz"]), t(q["au"]), t(q["av"]),
        t(vis), t(q["T0"]), t(q["a0"]), t(q["huber"]), t(q["cutoff"]), *q["intr"], **q["static"])
    T, a, energy, n_terms, iters = out
    assert iters.dtype == torch.int32 and n_terms.dtype == torch.int32
    if empty:
        np.testing.assert_allclose(T.numpy(), q["T0"], atol=1e-6)
        np.testing.assert_allclose(ref[0], q["T0"], atol=1e-6)
        assert int(n_terms) == 0 == int(ref[3])
        return
    assert int(n_terms) == int(ref[3]) > 30 * len(q["static"]["pattern"])
    assert _se3_dist(T.numpy(), ref[0]) < 1e-3
    assert abs(float(a) - float(ref[1])) < 1e-3
    np.testing.assert_allclose(float(energy), float(ref[2]), rtol=0.05)
    if is_top:
        # a 40x30 image with features moved to whole pixels: the level holds
        # the pose near the ground truth, it cannot refine it
        assert _se3_dist(T.numpy(), T_GT) < 1.5e-2
    else:
        # the level moved the pose towards the ground truth
        assert _se3_dist(T.numpy(), T_GT) < _se3_dist(q["T0"], T_GT)


@pytest.mark.parametrize("p", [9, 21, 25])
@pytest.mark.parametrize("n", [1, 7, 8, 336, 337, 1024])
def test_coarse_launch_plan(n, p):
    """The launch of K3 from the shape alone: every feature is owned by
    exactly one block of the cluster (blocks may own none), the bytes a block
    asks for are what its tables need and stay under 227 KB, and the windows
    are resident exactly when they fit."""
    cluster, threads, resident, smem = coarse_cuda.coarse_launch_plan(n, p)
    assert cluster == 8 and threads in (256, 512) and threads % 32 == 0
    feats = -(-n // cluster)
    owners = np.zeros(n, np.int32)
    for r in range(cluster):
        lo = min(r * feats, n)
        hi = min(lo + feats, n)
        owners[lo:hi] += 1
    assert (owners == 1).all()
    assert smem == coarse_cuda.coarse_block_bytes(threads, feats, p, resident)
    assert smem <= coarse_cuda.SMEM_MAX == 227 * 1024 and smem % 16 == 0
    with_windows = coarse_cuda.coarse_block_bytes(threads, feats, p, True)
    assert resident == (with_windows <= coarse_cuda.SMEM_MAX)
    assert with_windows - coarse_cuda.coarse_block_bytes(threads, feats, p, False) \
        == feats * 24 * 24 * 4
    # the main path's shapes are resident, a thousand features are not
    assert resident == (n <= 337)
    # more than two items per thread double the block
    assert threads == (512 if feats * p > 512 else 256)


def test_coarse_launch_plan_refuses_what_does_not_fit():
    """Even with the windows in global memory the per-item tables must fit:
    the wrapper raises, it does not fall back."""
    with pytest.raises(ValueError, match="shared memory"):
        coarse_cuda.coarse_launch_plan(8 * 300, 21)
    assert not coarse_cuda.coarse_launch_plan(8 * 250, 21)[2]

"""K1/K2's launch plan, multi-job extraction and the call sites that use them
(CPU).

* ``window_copy_plan`` on the main path's shapes (the aligned body) and on
  those the general body takes (a 47-px-wide level, win 22, a base 4 bytes
  past a 16-byte boundary), and the constants it shares with ``csrc/window.cu``;
* ``extract_windows_multi``'s plain version against the JAX package's
  ``extract_windows_xla``, job by job (1e-6, as ``test_torch_windows.py``);
* the coarse tracker's windows: one two-job extraction a level, each job the
  same bits as the single-image extraction it replaces;
* the keyframe paths (``memoize_level_windows``, ``init_seeds``) as one
  per-row-level gather: windows and anchors the same bits as one extraction a
  level merged by ``torch.where``, including detections whose level lies
  outside [0, n_levels) (zero window, anchor (0, 0), in both).
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hso_tpu.ops.gatherless import extract_windows_xla
from hso_tpu.ops.warp import memoize_level_windows as jax_memoize
from hso_tpu_torch import _cuda_build, testing
from hso_tpu_torch.cameras import PinholeCamera
from hso_tpu_torch.mapping import depth_filter
from hso_tpu_torch.math import se3np
from hso_tpu_torch.ops import window_cuda
from hso_tpu_torch.ops.gatherless import clip_anchor
from hso_tpu_torch.ops.warp import memoize_level_windows
from hso_tpu_torch.track import coarse_tracker
from hso_tpu_torch.utils.synthetic import PlaneScene

torch.set_num_threads(1)

ALIGNED_BASE = 0x7F0000001000


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


@pytest.fixture(scope="module")
def pyr():
    rs = np.random.RandomState(0)
    img = rs.uniform(0, 255, (240, 320)).astype(np.float32)
    out = [img]
    for _ in range(2):
        p = out[-1]
        out.append(0.25 * (p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]))
    return out


@pytest.mark.parametrize("h,w,win,plan", [
    (30, 40, 24, (True, 8, 256)),        # coarse level 4 ... level 1
    (60, 80, 24, (True, 8, 256)),
    (120, 160, 24, (True, 8, 256)),
    (240, 320, 24, (True, 8, 256)),      # also the matcher's levels
    (480, 640, 24, (True, 8, 256)),
    (480, 640, 40, (True, 4, 128)),      # the sweep
    (120, 160, 40, (True, 4, 128)),
    (480, 640, 44, (True, 4, 128)),      # the seed table's host windows
    (240, 320, 48, (True, 4, 128)),
])
def test_window_copy_plan_main_path(h, w, win, plan):
    assert window_cuda.window_copy_plan(h, w, win, ALIGNED_BASE) == plan


@pytest.mark.parametrize("h,w,win,base,windows", [
    (30, 47, 24, ALIGNED_BASE, 8),       # 752-px images: level 4 is 47 wide (pitch 188 bytes)
    (60, 94, 24, ALIGNED_BASE, 8),       # ... and level 3 94 wide
    (240, 320, 22, ALIGNED_BASE, 8),     # a window edge that is not a multiple of 4
    (30, 47, 22, ALIGNED_BASE, 8),
    (240, 320, 24, ALIGNED_BASE + 4, 8),  # a base 4 bytes past a 16-byte boundary
    (480, 640, 44, ALIGNED_BASE + 8, 4),
    (480, 640, 128, ALIGNED_BASE, 4),    # a row of chunks wider than a warp
])
def test_window_copy_plan_general_body(h, w, win, base, windows):
    assert window_cuda.window_copy_plan(h, w, win, base) == (False, windows, 32 * windows)


def test_window_copy_plan_refuses_empty_shapes():
    for args in ((0, 40, 24, 0), (30, 0, 24, 0), (30, 40, 0, 0)):
        with pytest.raises(ValueError):
            window_cuda.window_copy_plan(*args)


def test_window_plan_constants_match_the_source():
    """The Python plan mirrors ``window_plan`` in ``csrc/window.cu``: the same
    window-edge limit of the aligned body and the same blocks."""
    with open(os.path.join(_cuda_build.CSRC_DIR, "window.cu")) as fh:
        src = fh.read()
    assert int(re.search(r"kMaxAlignedWin = (\d+);", src).group(1)) == window_cuda.MAX_ALIGNED_WIN
    assert int(re.search(r"kMaxSources = (\d+);", src).group(1)) == window_cuda.MAX_SOURCES
    assert "const int windows = win <= 32 ? 8 : 4;" in src
    assert "addr % 16 == 0 && (4LL * w) % 16 == 0 && win % 4 == 0 && win >= 4" in src
    for entry in ("hso_extract_windows", "hso_extract_windows_jobs", "hso_pack_level_windows",
                  "hso_window_launch_plan"):
        assert f'extern "C" int {entry}(' in src
    # the job table as ctypes lays it out is the C struct's: pointers and ints
    # in declaration order, pointers on 8-byte boundaries
    job = _cuda_build.WindowJob
    assert [getattr(job, f).offset for f in ("img", "h", "w", "au", "av", "n", "out")] == \
        [0, 8, 12, 16, 24, 32, 40]
    assert ctypes.sizeof(job) == 48


def _jobs(pyr, win, seed):
    """Jobs on images of different sizes (one 47 px wide), with anchors at the
    corners, inside, partly outside and wholly outside (negative ones too)."""
    rs = np.random.RandomState(seed)
    odd = rs.uniform(0, 255, (50, 47)).astype(np.float32)
    jobs = []
    for img in (pyr[0], odd, pyr[2], pyr[1]):
        au, av = testing.window_anchor_cases(*img.shape, win, 30, seed=seed)
        au = np.concatenate([au, rs.randint(-win - 3, img.shape[1] + 4, 12)]).astype(np.int32)
        av = np.concatenate([av, rs.randint(-win - 3, img.shape[0] + 4, 12)]).astype(np.int32)
        jobs.append((img, au, av))
    return jobs


@pytest.mark.parametrize("win", [24, 22, 44])
def test_extract_windows_multi_matches_jax(pyr, win):
    jobs = _jobs(pyr, win, seed=3)
    t_jobs = [tuple(torch.as_tensor(a) for a in job) for job in jobs]
    before = dict(window_cuda.LAUNCHES)
    got = window_cuda.extract_windows_multi(t_jobs, win)           # CPU: the plain version
    assert window_cuda.LAUNCHES == before
    assert len(got) == len(jobs)
    for (img, au, av), out in zip(jobs, got):
        ref = extract_windows_xla(jnp.asarray(img), jnp.asarray(au), jnp.asarray(av), win)
        assert tuple(out.shape) == (len(au), win, win)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
        assert same_bits(out, window_cuda.extract_windows_plain(
            torch.as_tensor(img), torch.as_tensor(au), torch.as_tensor(av), win))


def test_multi_job_wrapper_refuses_what_it_cannot_launch():
    img = torch.zeros((32, 32))
    a = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):                     # CPU tensors: no kernel, no fallback
        window_cuda.extract_windows_multi_cuda([(img, a, a)], 24)
    with pytest.raises(ValueError):
        window_cuda.extract_windows_multi_prepare([], 24)
    with pytest.raises(ValueError):
        window_cuda.extract_windows_multi_prepare([(img, a, a)] * 9, 24)


def test_coarse_tracker_extracts_each_level_in_one_call():
    """The tracker cuts a level's ref and cur windows in one two-job call:
    one call for each of levels 3..1, each job the bits of the single-image
    extraction at the same anchors (what the tracker launched before)."""
    cam = PinholeCamera(320, 240, 200.0, 200.0, 160.0, 120.0)
    scene = PlaneScene(cam, z0=2.0, extent=2.5, seed=3, tex_size=1024)
    T_gt = se3np.exp(np.array([0.03, -0.02, 0.015, 0.006, -0.008, 0.004]))
    from hso_tpu_torch.image.pyramid import build_frame_pyramids

    ref_pyr = build_frame_pyramids(scene.render(), device="cpu")["pyr"]
    cur_pyr = build_frame_pyramids(scene.render(T_gt, exposure=0.97), device="cpu")["pyr"]
    px, f, dist = scene.grid_features(step=28, border=28)
    px, f, dist = testing.pad_features(px, f, dist, 96)
    calls = []

    def recording(jobs, win):
        calls.append((jobs, win))
        return window_cuda.extract_windows_multi(jobs, win)

    track = coarse_tracker.make_coarse_tracker(cam, max_level=3, inverse=True, device="cpu")
    old = coarse_tracker.extract_windows_multi
    coarse_tracker.extract_windows_multi = recording
    try:
        out = track(ref_pyr, cur_pyr, px, f, dist, se3np.identity().astype(np.float32), 1.0)
    finally:
        coarse_tracker.extract_windows_multi = old
    assert np.isfinite(out["T_cur_ref"].numpy()).all()
    assert [tuple(jobs[0][0].shape) for jobs, _ in calls] == [(30, 40), (60, 80), (120, 160)]
    for (jobs, win), level in zip(calls, (3, 2, 1)):
        assert win == coarse_tracker.WIN and len(jobs) == 2
        assert torch.equal(jobs[0][0], ref_pyr[level])
        assert torch.equal(jobs[1][0], cur_pyr[level])
        for got, job in zip(window_cuda.extract_windows_multi(jobs, win), jobs):
            assert same_bits(got, window_cuda.extract_windows_plain(*job, win))


def _old_level_loop(pyr, px, level, win, n_levels):
    """The keyframe windows as they were cut before: one extraction a level
    over every row, merged by a masked select."""
    n = px.shape[0]
    out_w = torch.zeros((n, win, win))
    out_a = torch.zeros((n, 2), dtype=torch.int32)
    for lvl in range(n_levels):
        scale = 1.0 / (1 << lvl)
        au, av = clip_anchor(px[:, 0] * scale, px[:, 1] * scale, win, 0, *pyr[lvl].shape)
        w_l = window_cuda.extract_windows_plain(pyr[lvl], au, av, win)
        sel = level == lvl
        out_w = torch.where(sel[:, None, None], w_l, out_w)
        out_a = torch.where(sel[:, None], torch.stack([au, av], dim=-1), out_a)
    return out_w, out_a


def _detections(n, seed):
    rs = np.random.RandomState(seed)
    px = np.stack([rs.uniform(-4, 324, n), rs.uniform(-4, 244, n)], -1).astype(np.float32)
    px[:4] = [[0, 0], [319, 239], [0.5, 238.75], [318.25, 0.5]]
    level = rs.randint(0, 3, n).astype(np.int32)
    level[[5, 9]] = -1                      # outside [0, n_levels): a zero window
    level[[6, 11]] = 3
    return px, level


@pytest.mark.parametrize("win", [24, 44])
def test_memoize_level_windows_is_one_gather(pyr, win):
    px, level = _detections(60, seed=6)
    pyr_t = tuple(torch.as_tensor(p) for p in pyr)
    calls = []
    from hso_tpu_torch.ops import epipolar

    def recording(*args):
        calls.append(args)
        return window_cuda.pack_level_windows_gather(*args)

    old = epipolar.pack_level_windows_gather
    epipolar.pack_level_windows_gather = recording
    try:
        w, a = memoize_level_windows(pyr_t, torch.as_tensor(px), torch.as_tensor(level), win=win)
    finally:
        epipolar.pack_level_windows_gather = old
    assert len(calls) == 1 and calls[0][4] == win       # one per-row-level gather (K2)
    w_old, a_old = _old_level_loop(pyr_t, torch.as_tensor(px), torch.as_tensor(level), win, 3)
    assert same_bits(w, w_old) and torch.equal(a, a_old) and a.dtype == torch.int32
    out = (level < 0) | (level >= 3)
    assert not bool(w[torch.as_tensor(out)].any()) and not bool(a[torch.as_tensor(out)].any())
    # and the JAX package's memoized windows, out-of-range rows included
    w_ref, a_ref = jax_memoize(tuple(jnp.asarray(p) for p in pyr), jnp.asarray(px),
                               jnp.asarray(level), win=win)
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), atol=1e-6)


def test_init_seeds_host_windows_through_one_gather(pyr):
    """``init_seeds`` stores each detection's 44-px host window from its own
    level: the bits of the old per-level loop, out-of-range levels included."""
    px, level = _detections(40, seed=9)
    n = px.shape[0]
    rs = np.random.RandomState(10)
    f = rs.normal(size=(n, 3)).astype(np.float32)
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    det = {"px": torch.as_tensor(px), "level": torch.as_tensor(level),
           "species": torch.ones(n, dtype=torch.int32), "grad": torch.zeros((n, 2)),
           "valid": torch.ones(n, dtype=torch.bool)}
    seeds = depth_filter.empty_seeds(64, device="cpu")
    pyr_t = tuple(torch.as_tensor(p) for p in pyr)
    out = depth_filter.init_seeds(seeds, det, pyr_t, torch.as_tensor(f), 0, 1, 3.0, 1.0, 200.0)
    w_old, a_old = _old_level_loop(pyr_t, torch.as_tensor(px), torch.as_tensor(level),
                                   depth_filter.HOST_WIN, 3)
    taken = out["valid"]
    assert int(taken.sum()) == n
    # free slots are filled in slot order: detection k lands in slot k
    assert same_bits(out["host_win"][:n], w_old)
    assert torch.equal(out["host_anchor"][:n], a_old)
    assert not bool(out["host_win"][n:].any())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Drives the port's main path — the whole per-frame step,
``hso_tpu_torch.pipeline.fused_step.make_frame_step`` (tracking, matching,
pose refinement and the depth-filter seed sweep) — at full width (pinhole
640×480, default ``Config``, 336 grid cells, 4096 point rows with 24×24
windows, 1024 seed slots, state and seed table resumed from
``artifacts/bench_boot.npz``) over 24 rendered frames, after building every
CUDA kernel from the sources in ``hso_tpu_torch/csrc`` and holding each
against its plain PyTorch version on the card.  The tracking half alone
(``make_track_step``) is driven over the same frames, and the seed table's
life (``init_seeds``, sweeps, ``harvest_and_prune``) is run on the card and
on the CPU from the same state.  Needs one CUDA device; exits non-zero
without one.  Imports nothing of JAX.

With ``--other-csrc DIR`` (another version of ``hso_tpu_torch/csrc`` with the
same C interface, for instance the parent commit's) the ``kernels`` phase also
prints how far K6 on the recorded call is from that version's K6, and the
``frame`` phase runs its 24 frames again on that version (K1 as two
single-image launches a level) and requires every output to hold the same bits.

Phases (one JSON line each): ``device``, ``build`` (with the registers, spills
and static shared memory of every kernel, and the launch plans of K1/K2, K4 and
K6 in Python and in C), ``kernels`` (one line per
kernel and shape; K3 at each of its four levels and in its variant that leaves
the windows in global memory), ``latency`` (the card's own figures for a block
barrier, a cluster barrier, the reductions and the scalar steps of K3 and K5,
and the latency floor they give), ``track``, ``frame``, ``fc_frame`` (one frame
forced through the forward-compositional branch, card against CPU), ``seeds``;
then the ``{"kernels": [...]}`` summary, the card line and, last, the
``{"ok": true, "device": {...}}`` line.  Any failed check raises.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import io
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from hso_tpu_torch import _cuda_build  # noqa: E402
from hso_tpu_torch.cameras import PinholeCamera  # noqa: E402
from hso_tpu_torch.config import Config  # noqa: E402
from hso_tpu_torch.image.pyramid import build_frame_pyramids  # noqa: E402
from hso_tpu_torch.math import se3np  # noqa: E402
from hso_tpu_torch.mapping import depth_filter  # noqa: E402
from hso_tpu_torch import testing  # noqa: E402
from hso_tpu_torch.ops import align_cuda, epipolar, epipolar_cuda, window_cuda  # noqa: E402
from hso_tpu_torch.ops.gatherless import clip_anchor  # noqa: E402
from hso_tpu_torch.pipeline.fused_step import make_frame_step, make_track_step  # noqa: E402
from hso_tpu_torch.track import coarse_cuda, pose_cuda  # noqa: E402
from hso_tpu_torch.utils import checkpoint  # noqa: E402
from hso_tpu_torch.utils.evaluate import ate  # noqa: E402
from hso_tpu_torch.utils.synthetic import BoxScene  # noqa: E402

BOOT_NPZ = os.path.join(ROOT, "artifacts", "bench_boot.npz")
N_FRAMES = 24
N_TIMED = 20
N_WARM = 3

#: published peaks of one H100 SXM: HBM bytes/s, float32 FLOP/s outside the
#: tensor cores (none of these kernels uses the tensor cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

COUNTERS = {
    "extract_windows": window_cuda.LAUNCHES,
    "pack_level_windows": window_cuda.LAUNCHES,
    "coarse_level_ic": coarse_cuda.LAUNCHES,
    "align_match": align_cuda.LAUNCHES,
    "pose_lm": pose_cuda.LAUNCHES,
    "zmncc_line_scores": epipolar_cuda.LAUNCHES,
}
KERNEL_META = {
    "extract_windows": ("hso_tpu_torch/csrc/window.cu", "hso_tpu/ops/window_pallas.py:119"),
    "pack_level_windows": ("hso_tpu_torch/csrc/window.cu", "hso_tpu/ops/window_pallas.py:173"),
    "coarse_level_ic": ("hso_tpu_torch/csrc/coarse.cu", "hso_tpu/track/coarse_pallas.py:300"),
    "align_match": ("hso_tpu_torch/csrc/align.cu", "hso_tpu/ops/align_pallas.py:228"),
    "pose_lm": ("hso_tpu_torch/csrc/pose.cu", "hso_tpu/track/pose_pallas.py:233"),
    "zmncc_line_scores": ("hso_tpu_torch/csrc/epipolar.cu",
                          "hso_tpu/ops/epipolar_pallas.py:157"),
}
#: kernels of the tracking half (the older path), and of the whole step
TRACK_KERNELS = ("extract_windows", "pack_level_windows", "coarse_level_ic", "align_match",
                 "pose_lm")
FRAME_KERNELS = TRACK_KERNELS + ("zmncc_line_scores",)
SEED_WIN = depth_filter.HOST_WIN


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def zero_counters() -> None:
    for name, d in COUNTERS.items():
        d[name] = 0


def read_counters() -> dict:
    return {name: d[name] for name, d in COUNTERS.items()}


# ------------------------------------------------------------------ scene
def bench_camera() -> PinholeCamera:
    return PinholeCamera(640, 480, 400.0, 400.0, 320.0, 240.0)


def bench_scene(cam) -> BoxScene:
    return BoxScene(cam, half_width=2.0, half_height=1.5, depth=4.5, seed=3, stepped_back=True)


def trajectory(n: int) -> list:
    """Brisk oscillating sweep inside the box (the benchmark's trajectory)."""
    poses = []
    for k in range(n):
        t = k / 18.0
        xi = np.r_[0.8 * np.sin(0.8 * t), 0.12 * np.sin(0.5 * t), 0.10 * np.sin(0.35 * t),
                   0.02 * np.sin(0.9 * t), -0.05 * np.sin(0.6 * t), 0.02 * np.sin(0.4 * t)]
        poses.append(se3np.exp(xi))
    return poses


def grid_of(cam, cfg) -> tuple:
    cell = max(int(np.sqrt(cam.width * cam.height / cfg.max_fts) * 0.8), 16)
    return (cell, -(-cam.height // cell), -(-cam.width // cell))


def build_step(cam, cfg, device, whole: bool = False):
    """The tracking step, or with ``whole`` the whole per-frame step."""
    grid = grid_of(cam, cfg)
    n_obs_pad = max(cfg.n_fts_max, grid[1] * grid[2])
    make = make_frame_step if whole else make_track_step
    step = make(
        cam, grid, cfg.klt_max_level, cfg.klt_min_level, cfg.coarse_n_iter,
        cfg.coarse_pattern_offset, cfg.poseoptim_thresh, n_obs_pad=n_obs_pad,
        edgelet_cos_angle=cfg.edgelet_angle, align_max_iter=cfg.align_max_iter,
        patch_closest=(cfg.patch_source == "closest"), device=device)
    return step, grid, n_obs_pad


# ------------------------------------------------------------------ timing
def time_ms(fn, device, inner=10, n_timed=N_TIMED, n_warm=N_WARM) -> float:
    """Time of one call in ms: CUDA events around a run of ``inner``
    back-to-back calls, after a warm-up; the median of ``n_timed`` such runs
    over ``inner``.  (Events around a single launch of a microsecond kernel
    would time the launch, not the kernel.)"""
    for _ in range(n_warm):
        fn()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(n_timed):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize(device)
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def bound(bytes_moved: float, flops: float) -> tuple:
    t_b = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_f = flops / PEAK_F32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def se3_dist(Ta: torch.Tensor, Tb: torch.Tensor) -> float:
    """|log(Ta · Tb⁻¹)| in float64."""
    A = Ta.detach().double().cpu().numpy()
    B = Tb.detach().double().cpu().numpy()
    return float(np.linalg.norm(se3np.log(se3np.mul(A, se3np.inv(B)))))


# ------------------------------------------------------------------ capture
class Recorder:
    """Wraps a dispatcher: records the arguments of every call, then calls it."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = []

    def __call__(self, *args, **kwargs):
        kept = tuple(a.contiguous() if isinstance(a, torch.Tensor) else a for a in args)
        self.calls.append((kept, kwargs))
        return self.fn(*args, **kwargs)


class Tally:
    """Wraps a dispatcher at a call site: counts its calls by window edge (or
    whatever ``win_of`` reads from the call), then calls it."""

    def __init__(self, fn, win_of):
        self.fn = fn
        self.win_of = win_of
        self.counts = {}

    def __call__(self, *args, **kwargs):
        win = int(self.win_of(args, kwargs))
        self.counts[win] = self.counts.get(win, 0) + 1
        return self.fn(*args, **kwargs)


@contextlib.contextmanager
def patched(pairs):
    """Temporarily set module attributes: ``pairs`` is [(module, name, value)]."""
    old = [(m, n, getattr(m, n)) for m, n, _ in pairs]
    for m, n, v in pairs:
        setattr(m, n, v)
    try:
        yield
    finally:
        for m, n, v in old:
            setattr(m, n, v)


def plain_kernels():
    """Route every kernel call site to the kernel's plain version, by name
    (used for the on-card reference run; the dispatchers never do this)."""
    from hso_tpu_torch.track import coarse_tracker, matcher, pose_optimizer

    return patched([
        (coarse_tracker, "extract_windows_multi", window_cuda.extract_windows_multi_plain),
        (epipolar, "pack_level_windows_gather", window_cuda.pack_level_windows_plain),
        (matcher, "align_match", align_cuda.align_match_plain),
        (depth_filter, "align_match", align_cuda.align_match_plain),
        (coarse_tracker, "coarse_level_ic", coarse_cuda.coarse_level_ic_plain),
        (pose_optimizer, "pose_lm", pose_cuda.pose_lm_plain),
        (epipolar, "zmncc_line_scores", epipolar_cuda.zmncc_line_scores_plain),
    ])


def shape_tallies():
    """Counting shims on the call sites of the kernels that run at more than
    one shape (by window edge; K3 by the level's image height): returns (the
    patch context, {kernel: Tally})."""
    from hso_tpu_torch.track import coarse_tracker, matcher

    k1 = Tally(window_cuda.extract_windows_multi, lambda a, k: a[1])
    k2 = Tally(window_cuda.pack_level_windows_gather, lambda a, k: a[4])
    k4 = Tally(align_cuda.align_match, lambda a, k: k["win"])
    k3 = Tally(coarse_cuda.coarse_level_ic, lambda a, k: k["h_img"])
    ctx = patched([(coarse_tracker, "extract_windows_multi", k1),
                   (coarse_tracker, "coarse_level_ic", k3),
                   (epipolar, "pack_level_windows_gather", k2),
                   (matcher, "align_match", k4),
                   (depth_filter, "align_match", k4)])
    return ctx, {"extract_windows": k1, "pack_level_windows": k2, "align_match": k4,
                 "coarse_level_ic": k3}


def capture_kernel_inputs(step, state, img):
    """Run one whole step with recorders on the dispatchers and return the
    recorded calls: the shapes and data the main path gives the kernels."""
    from hso_tpu_torch.track import coarse_tracker, matcher, pose_optimizer

    rec = {
        "windows": Recorder(window_cuda.extract_windows_multi),
        "coarse": Recorder(coarse_cuda.coarse_level_ic),
        "align": Recorder(align_cuda.align_match),
        "pose": Recorder(pose_cuda.pose_lm),
        "seed_align": Recorder(align_cuda.align_match),
        "pack": Recorder(window_cuda.pack_level_windows_gather),
        "zmncc": Recorder(epipolar_cuda.zmncc_line_scores),
    }
    with patched([(coarse_tracker, "extract_windows_multi", rec["windows"]),
                  (coarse_tracker, "coarse_level_ic", rec["coarse"]),
                  (matcher, "align_match", rec["align"]),
                  (pose_optimizer, "pose_lm", rec["pose"]),
                  (depth_filter, "align_match", rec["seed_align"]),
                  (epipolar, "pack_level_windows_gather", rec["pack"]),
                  (epipolar, "zmncc_line_scores", rec["zmncc"])]):
        out = run_one(step, state, img, whole=True)
    return {k: r.calls for k, r in rec.items()}, out


# ------------------------------------------------------------------ kernels phase
def level_stack(pyr, n_levels, device):
    """The first ``n_levels`` pyramid levels in one zero-padded (L, H0, W0) tensor."""
    h0, w0 = pyr[0].shape
    stack = torch.zeros((n_levels, h0, w0), device=device)
    for l in range(n_levels):
        hl, wl = pyr[l].shape
        stack[l, :hl, :wl] = pyr[l]
    return stack


def gather_ms(stack, level, au, av, win, device):
    """Time of one advanced-indexing gather of the same windows from a padded
    level stack (the library yardstick of K1/K2)."""
    ar = torch.arange(win, device=device)
    rows = av.long()[:, None] + ar
    cols = au.long()[:, None] + ar
    lv = level.long()[:, None, None]
    return time_ms(lambda: stack[lv, rows[:, :, None], cols[:, None, :]], device)


def c_window_plan(h: int, w: int, win: int, addr: int) -> tuple:
    """K1/K2's plan for one source as the library computes it."""
    out3 = (ctypes.c_int * 3)()
    rc = _cuda_build.lib().hso_window_launch_plan(h, w, win, addr, ctypes.byref(out3))
    assert rc == 0, f"the library has no window plan for {h}x{w} win {win}"
    return bool(out3[0]), out3[1], out3[2]


def window_plan_of(img: torch.Tensor, win: int) -> tuple:
    """The window plan of one source, asserted the same in Python and in C."""
    plan = window_cuda.window_copy_plan(*img.shape, win, img.data_ptr())
    assert plan == c_window_plan(*img.shape, win, img.data_ptr()), \
        f"window plans differ at {tuple(img.shape)} win {win}: {plan}"
    return plan


def hold_windows(got, ref, what) -> float:
    """Kernel windows against the plain version's: the same bits (tolerance
    0.0: a window is a copy).  Returns the largest difference (0.0)."""
    for a, b in zip(got, ref):
        assert a.shape == b.shape and same_bits(a, b), f"{what}: not the plain version's bits"
    return max((float((a - b).abs().max()) for a, b in zip(got, ref) if a.numel()), default=0.0)


def random_anchors(n, h, w, win, g, device):
    """Anchors from ``win + 3`` px beyond the top-left corner to 3 px beyond the
    bottom-right one: windows inside, partly outside and wholly outside."""
    au = torch.randint(-win - 3, w + 4, (n,), generator=g)
    av = torch.randint(-win - 3, h + 4, (n,), generator=g)
    return au.to(torch.int32).to(device), av.to(torch.int32).to(device)


def unaligned_copy(img: torch.Tensor) -> torch.Tensor:
    """The same image at a base address 4 bytes past a 16-byte boundary."""
    flat = torch.zeros(img.numel() + 1, device=img.device)
    flat[1:] = img.reshape(-1)
    return flat[1:].view(img.shape)


def contiguous_jobs(jobs) -> list:
    """K1 jobs as the dispatcher hands them to the kernel: every tensor contiguous."""
    return [tuple(t.contiguous() for t in job) for job in jobs]


def check_windows(calls_k1, calls_k2, cur_pyr, device, results):
    """K1 and K2 against their plain versions at tolerance 0.0 on both bodies:
    the tracker's recorded two-job launches (aligned body at every level), the
    matcher's recorded K2 calls, anchors partly and wholly outside the image
    (negative ones too), a 30x47 image with win 22 and 24 and an image at an
    unaligned base (general body), a multi-job launch mixing image sizes and
    bodies, K2 rows at level -1 and n_levels; every launch repeated bitwise."""
    g = torch.Generator(device="cpu").manual_seed(0)
    worst = 0.0
    plans = {}
    # the recorded arguments are the dispatcher's, before its .contiguous()
    calls_k1 = [((contiguous_jobs(jobs), win), kw) for (jobs, win), kw in calls_k1]

    def k1(jobs, win, what, body=None):
        nonlocal worst
        for img, _, _ in jobs:
            plan = window_plan_of(img, win)
            base = "" if img.data_ptr() % 16 == 0 else ", base 4 bytes past 16"
            plans[f"{img.shape[0]}x{img.shape[1]} win {win}{base}"] = plan
            if body is not None:
                assert plan[0] == (body == "aligned"), f"{what}: expected the {body} body"
        got = window_cuda.extract_windows_multi_cuda(jobs, win)
        worst = max(worst, hold_windows(got, window_cuda.extract_windows_multi_plain(jobs, win),
                                        what))
        hold_windows(window_cuda.extract_windows_multi_cuda(jobs, win), got, f"{what}, again")
        if len(jobs) > 1:       # the single-image entry gives the same bits
            hold_windows([window_cuda.extract_windows_cuda(*j, win) for j in jobs], got,
                         f"{what}, one job a launch")

    def k2(pyr, level, au, av, win, n_levels, what, body=None):
        nonlocal worst
        for img in pyr[:n_levels]:
            plan = window_plan_of(img, win)
            if body is not None:
                assert plan[0] == (body == "aligned"), f"{what}: expected the {body} body"
        got = window_cuda.pack_level_windows_cuda(pyr, level, au, av, win, n_levels)
        ref = window_cuda.pack_level_windows_plain(pyr, level, au, av, win, n_levels)
        worst = max(worst, hold_windows([got], [ref], what))
        hold_windows([window_cuda.pack_level_windows_cuda(pyr, level, au, av, win, n_levels)],
                     [got], f"{what}, again")
        return got

    # K1 as the tracker calls it: ref and cur windows of a level in one launch
    assert len(calls_k1) == 4, f"expected 4 two-job window launches a frame, got {len(calls_k1)}"
    for (jobs, win), _ in calls_k1:
        assert win == 24 and len(jobs) == 2
        k1(jobs, win, f"K1 at {tuple(jobs[0][0].shape)}", body="aligned")
    # anchors partly and wholly outside, both bodies, and a launch that mixes
    # image sizes and bodies
    img1 = calls_k1[-1][0][0][1][0]
    odd = torch.rand((30, 47), generator=g).to(device)
    for win in (24, 22, 40, 44):
        k1([(img1, *random_anchors(336, *img1.shape, win, g, device))], win,
           f"K1 anchors outside, win {win}", body="aligned" if win % 4 == 0 else "general")
        k1([(unaligned_copy(img1), *random_anchors(200, *img1.shape, win, g, device))], win,
           f"K1 unaligned base, win {win}", body="general")
    for win in (22, 24):
        k1([(odd, *random_anchors(300, 30, 47, win, g, device))], win,
           f"K1 30x47 win {win}", body="general")
    mixed = [cur_pyr[4], odd, cur_pyr[2], unaligned_copy(cur_pyr[3]), cur_pyr[0]]
    k1([(im, *random_anchors(int(torch.randint(1, 90, (1,), generator=g)), *im.shape, 24, g,
                             device)) for im in mixed], 24, "K1, five jobs of different sizes")

    # K2: the matcher's recorded calls, rows at level -1 and n_levels, centres
    # partly outside, and a pyramid the general body takes
    k2_24 = [c for c in calls_k2 if c[0][4] == 24]
    assert len(k2_24) == 2, f"expected 2 win-24 window packs a frame, got {len(k2_24)}"
    for (pyr, level, au, av, win, n_levels), _ in k2_24:
        pyr = [p.contiguous() for p in pyr[:n_levels]]
        k2(pyr, level, au, av, win, n_levels, "K2, recorded matcher call", body="aligned")
        bad = level.clone()
        bad[0], bad[1], bad[2] = -1, n_levels, 99
        got = k2(pyr, bad, au, av, win, n_levels, "K2, levels out of range")
        assert not bool(got[:3].any()), "K2: a row at a level out of range is not zero"
    n_levels = 3
    for s in (336, 168):
        level = torch.randint(0, n_levels, (s,), generator=g).to(torch.int32)
        dims = torch.tensor([list(cur_pyr[l].shape) for l in range(n_levels)])
        hw = dims[level.long()].float()
        cu = (torch.rand(s, generator=g) * (hw[:, 1] + 10.0) - 5.0)
        cv = (torch.rand(s, generator=g) * (hw[:, 0] + 10.0) - 5.0)
        au = torch.zeros(s, dtype=torch.int32)
        av = torch.zeros(s, dtype=torch.int32)
        for l in range(n_levels):
            a_u, a_v = clip_anchor(cu, cv, 24, 0, *cur_pyr[l].shape)
            au = torch.where(level == l, a_u, au)
            av = torch.where(level == l, a_v, av)
        k2(cur_pyr, level.to(device), au.to(device), av.to(device), 24, n_levels,
           f"K2, centres partly outside, S={s}")
    odd_pyr = [torch.rand((60 >> l, 94 >> l), generator=g).to(device) for l in range(3)]
    for win in (22, 24):
        level = torch.randint(-1, 4, (257,), generator=g).to(torch.int32).to(device)
        au, av = random_anchors(257, 60, 94, win, g, device)
        k2(odd_pyr, level, au, av, win, 3, f"K2 general body, win {win}", body="general")

    # timing: K1 at level 1 as the tracker launches it, K2 on the matcher's first call
    (jobs, win), _ = calls_k1[-1]
    n = jobs[0][1].shape[0]
    h, w = jobs[0][0].shape
    stack = torch.stack([jobs[0][0], jobs[1][0]])
    lv = torch.cat([torch.zeros(n, dtype=torch.int32), torch.ones(n, dtype=torch.int32)])
    b_ms, b_by = bound(2 * (2 * n * win * win * 4 + 2 * n * 4), 0)
    results["extract_windows"] = dict(
        max_abs_err=worst, tol=0.0,
        shape=f"2 jobs x N={n} win={win} image={h}x{w} (level 1, one launch; also levels 4-2)",
        ms=time_ms(lambda: window_cuda.extract_windows_multi_cuda(jobs, win), device),
        plain_ms=time_ms(lambda: window_cuda.extract_windows_multi_plain(jobs, win), device,
                         inner=2),
        library_ms=gather_ms(stack, lv.to(device), torch.cat([jobs[0][1], jobs[1][1]]),
                             torch.cat([jobs[0][2], jobs[1][2]]), win, device),
        bound_ms=b_ms, bound_by=b_by, plans=plans)
    (pyr, level, au, av, win, n_levels), _ = k2_24[0]
    pyr = [p.contiguous() for p in pyr[:n_levels]]
    s = level.shape[0]
    b_ms, b_by = bound(2 * s * win * win * 4 + 3 * s * 4, 0)
    results["pack_level_windows"] = dict(
        max_abs_err=worst, tol=0.0, shape=f"S={s} win={win} levels={n_levels} (matcher)",
        ms=time_ms(lambda: window_cuda.pack_level_windows_cuda(
            pyr, level, au, av, win, n_levels), device),
        plain_ms=time_ms(lambda: window_cuda.pack_level_windows_plain(
            pyr, level, au, av, win, n_levels), device, inner=2),
        library_ms=gather_ms(level_stack(pyr, n_levels, device), level, au, av, win, device),
        bound_ms=b_ms, bound_by=b_by)


def same_bits(a, b) -> bool:
    """Two results (float or integer tensors) hold the same bits."""
    a, b = torch.as_tensor(a).float(), torch.as_tensor(b).float()
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def compare_coarse(got, ref, what):
    """A coarse level's kernel result against the plain one, tolerances of
    ``tests/test_torch_coarse.py``; returns the largest entry difference."""
    d_T = se3_dist(got[0], ref[0])
    d_a = abs(float(got[1]) - float(ref[1]))
    e_k, e_p = float(got[2]), float(ref[2])
    assert d_T < 1e-3 and d_a < 1e-3, f"{what} disagrees: dT={d_T} da={d_a}"
    assert abs(e_k - e_p) <= 0.05 * abs(e_p) + 1e-6, f"{what}: energy {e_k} vs {e_p}"
    assert int(got[3]) == int(ref[3]), f"{what}: n_terms {int(got[3])} vs {int(ref[3])}"
    return max(float((got[0] - ref[0]).abs().max()), d_a)


def tiled_coarse_call(args, kw, n):
    """A recorded coarse level repeated along the feature axis up to ``n``
    features: a shape whose windows do not fit the cluster's shared memory."""
    n_rec = args[1].shape[0]
    idx = torch.arange(n, device=args[0].device) % n_rec
    return tuple(a[idx].contiguous() for a in args[:7]) + tuple(args[7:]), kw


def c_launch_plan(n: int, p: int) -> tuple:
    """The launch plan as the library computes it (cluster, threads, resident,
    bytes)."""
    out4 = (ctypes.c_int * 4)()
    rc = _cuda_build.lib().hso_coarse_launch_plan(n, p, ctypes.byref(out4))
    assert rc == 0, f"the library has no launch plan for N={n} P={p}"
    return out4[0], out4[1], bool(out4[2]), out4[3]


def c_plan3(fn_name: str, *shape) -> tuple:
    """A three-number launch plan (K6, K4) as the library computes it."""
    out3 = (ctypes.c_int * 3)()
    rc = getattr(_cuda_build.lib(), fn_name)(*shape, ctypes.byref(out3))
    assert rc == 0, f"{fn_name}{shape}: the library has no launch plan"
    return out3[0], out3[1], out3[2]


def check_launch_plans() -> dict:
    """The launch plans of K1/K2, K6 and K4 are the same pure function in
    Python and in C, at the shapes of the main path and where shared memory
    (K4, K6) or alignment (K1/K2) cuts them."""
    plans = {}
    for shape in ((480, 640, 44, 0), (240, 320, 24, 256), (30, 40, 24, 512), (120, 160, 40, 0),
                  (30, 47, 22, 0), (30, 47, 24, 0), (240, 320, 24, 4), (240, 320, 124, 0),
                  (240, 320, 128, 0), (60, 80, 48, 16), (60, 80, 2, 0)):
        plan = window_cuda.window_copy_plan(*shape)
        assert plan == c_window_plan(*shape), f"K1/K2 window plans differ at {shape}: {plan}"
        plans[f"window{shape}"] = plan
    out3 = (ctypes.c_int * 3)()
    assert _cuda_build.lib().hso_window_launch_plan(0, 40, 24, 0, ctypes.byref(out3)) == 1
    for shape in ((1024, 40, 40), (256, 48, 40), (48, 48, 40), (3, 40, 40), (16, 160, 64),
                  (16, 236, 40)):
        plan = epipolar_cuda.zmncc_launch_plan(*shape)
        assert plan == c_plan3("hso_zmncc_launch_plan", *shape), \
            f"K6 launch plans differ at {shape}: {plan}"
        plans[f"zmncc{shape}"] = plan
    for shape in ((336, 24), (1024, 40), (333, 24), (2, 40), (16, 200), (16, 240)):
        plan = align_cuda.align_launch_plan(*shape)
        assert plan == c_plan3("hso_align_launch_plan", *shape), \
            f"K4 launch plans differ at {shape}: {plan}"
        plans[f"align{shape}"] = plan
    out3 = (ctypes.c_int * 3)()
    assert _cuda_build.lib().hso_zmncc_launch_plan(4, 300, 40, ctypes.byref(out3)) == 1
    assert _cuda_build.lib().hso_align_launch_plan(4, 300, ctypes.byref(out3)) == 1
    return plans


def check_coarse(calls, device, results):
    assert len(calls) == 4, f"expected 4 coarse levels on an IC frame, got {len(calls)}"
    heights = [kw["h_img"] for _, kw in calls]
    assert heights == [30, 60, 120, 240], f"coarse levels out of order: {heights}"
    for level, (args, kw) in zip((4, 3, 2, 1), calls):
        n, p = args[1].shape
        plan = coarse_cuda.coarse_launch_plan(n, p)
        assert plan == c_launch_plan(n, p), f"launch plans differ: {plan} {c_launch_plan(n, p)}"
        assert plan[2], f"level {level}: the windows of N={n} P={p} should be resident"
        got = coarse_cuda.coarse_level_ic_cuda(*args, **kw)
        ref = coarse_cuda.coarse_level_ic_plain(*args, **kw)
        worst = compare_coarse(got, ref, f"coarse level {level}")
        again = coarse_cuda.coarse_level_ic_cuda(*args, **kw)
        assert all(same_bits(x, y) for x, y in zip(got, again)), \
            f"coarse level {level}: second run differs"
        if level == 1:
            # adversarial: nothing visible -> the state comes back unchanged
            a2 = list(args)
            a2[6] = torch.zeros_like(args[6])
            for fn in (coarse_cuda.coarse_level_ic_cuda, coarse_cuda.coarse_level_ic_plain):
                T_e, a_e, _, nt_e, _ = fn(*a2, **kw)
                assert float((T_e - args[7]).abs().max()) <= 1e-6 and int(nt_e) == 0
                assert abs(float(a_e) - float(args[8])) <= 1e-6
            # adversarial: a far-off initial pose; both must agree on what they return
            a3 = list(args)
            T_far = args[7].clone()
            T_far[0, 3] += 0.4
            a3[7] = T_far
            got_far = coarse_cuda.coarse_level_ic_cuda(*a3, **kw)
            ref_far = coarse_cuda.coarse_level_ic_plain(*a3, **kw)
            d_far = se3_dist(got_far[0], ref_far[0])
            assert d_far < 1e-3, f"coarse level (far-off init) disagrees: {d_far}"
            worst = max(worst, float((got_far[0] - ref_far[0]).abs().max()))
            # a few features only: blocks of the cluster that own none
            for n_few in (1, 7, 13):
                a4 = tuple(a[:n_few].contiguous() for a in args[:7]) + tuple(args[7:])
                compare_coarse(coarse_cuda.coarse_level_ic_cuda(*a4, **kw),
                               coarse_cuda.coarse_level_ic_plain(*a4, **kw),
                               f"coarse level 1 cut to {n_few} features")

        iters = int(got[4])
        evals = iters + 1
        nbytes = n * 576 * 4 + n * p * 4 + n * p * 24 + n * 12 + n * 8 + n + 12 * 4 + 12 + 64
        flops = evals * (n * p * 100 + n * 30)
        b_ms, b_by = bound(nbytes, flops)
        launch, _ = coarse_cuda.coarse_level_ic_prepare(*args, **kw)
        results[f"coarse_level_ic@level{level}"] = dict(
            max_abs_err=worst, tol=1e-3,
            shape=f"N={n} P={p} G={kw['g']} image={kw['h_img']}x{kw['w_img']} (level {level}), "
                  f"{iters} iterations (plain: {int(ref[4])})",
            evaluations=evals, threads=plan[1], smem_bytes=plan[3],
            ms=time_ms(launch, device),
            plain_ms=time_ms(lambda: coarse_cuda.coarse_level_ic_plain(*args, **kw), device,
                             inner=2, n_timed=5, n_warm=1),
            library_ms=None, bound_ms=b_ms, bound_by=b_by)

    # the variant that leaves the windows in global memory, on a shape that
    # forces it: level 1 repeated up to 1024 features
    args, kw = tiled_coarse_call(*calls[-1], 1024)
    n, p = args[1].shape
    plan = coarse_cuda.coarse_launch_plan(n, p)
    assert plan == c_launch_plan(n, p) and not plan[2], f"N={n} P={p} should not be resident"
    got = coarse_cuda.coarse_level_ic_cuda(*args, **kw)
    ref = coarse_cuda.coarse_level_ic_plain(*args, **kw)
    worst = compare_coarse(got, ref, "coarse level, windows in global memory")
    again = coarse_cuda.coarse_level_ic_cuda(*args, **kw)
    assert all(same_bits(x, y) for x, y in zip(got, again))
    iters = int(got[4])
    nbytes = n * 576 * 4 + n * p * 4 + n * p * 24 + n * 12 + n * 8 + n + 12 * 4 + 12 + 64
    b_ms, b_by = bound(nbytes, (iters + 1) * (n * p * 100 + n * 30))
    launch, _ = coarse_cuda.coarse_level_ic_prepare(*args, **kw)
    results["coarse_level_ic@global-windows"] = dict(
        max_abs_err=worst, tol=1e-3,
        shape=f"N={n} P={p} (level 1 repeated; not a shape of the main path), {iters} iterations",
        evaluations=iters + 1, threads=plan[1], smem_bytes=plan[3],
        ms=time_ms(launch, device),
        plain_ms=time_ms(lambda: coarse_cuda.coarse_level_ic_plain(*args, **kw), device,
                         inner=1, n_timed=3, n_warm=1),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)


def compare_align(got, ref, what):
    """K4's packed result against the plain one: the converged flags and the
    set of non-finite positions exact, px 5e-3, and on converged rows NCC
    1e-3, gradient 2e-2, chi2 1e-2 relative.  Returns the px difference."""
    conv = ref[2] > 0.5
    assert bool(((got[2] > 0.5) == conv).all()), f"{what}: converged flags differ"
    lost = ~torch.isfinite(ref[:2])
    assert bool((~torch.isfinite(got[:2]) == lost).all()), f"{what}: non-finite px differ"
    d_px = float(torch.where(lost, torch.zeros_like(ref[:2]), got[:2] - ref[:2]).abs().max())
    assert d_px <= 5e-3, f"{what}: px differ by {d_px}"
    if bool(conv.any()):
        assert float((got[3] - ref[3])[conv].abs().max()) <= 1e-3, f"{what}: ncc"
        assert float((got[4:6] - ref[4:6])[:, conv].abs().max()) <= 2e-2, f"{what}: gradient"
        rel = ((got[6] - ref[6]).abs() / (ref[6].abs() + 1.0))[conv]
        assert float(rel.max()) <= 1e-2, f"{what}: chi2"
    return d_px


def align_iterations(is_edge, direction, ref_border, px_init, valid, windows,
                     au, av, hs, ws, win: int, n_iter: int = 10) -> torch.Tensor:
    """(S,) int32: the number of iterations after which each candidate's
    result no longer changes: the smallest ``k`` for which the plain version
    run with ``n_iter = k`` returns the bits it returns with ``n_iter``
    (0 for a candidate that never moves).  That is where a loop that stops a
    candidate once it is inactive leaves it."""
    runs = [align_cuda.align_match_plain(is_edge, direction, ref_border, px_init, valid, windows,
                                         au, av, hs, ws, win, k).view(torch.int32)
            for k in range(n_iter + 1)]
    its = torch.full((windows.shape[0],), n_iter, dtype=torch.int32, device=windows.device)
    for k in range(n_iter - 1, -1, -1):
        same = (runs[k] == runs[n_iter]).all(dim=0)
        its = torch.where(same, torch.full_like(its, k), its)
    return its


LEFT_EDGE = "patches on the window's left edge"


def align_variants(args):
    """A recorded K4 call and what the kernel's branches make interesting:
    ``valid`` all true, all corners, all edgelets, a batch that does not fill
    its last block, and rows that start outside their window, on its very
    edge, and at a NaN position; and a batch whose patches all start on their
    window's left edge, so that a first update to the left carries a row out."""
    is_edge, direction, ref_border, px_init, valid, windows, au, av, hs, ws = args
    yield "as recorded", args
    everyone = torch.ones_like(valid)
    yield "valid all true", args[:4] + (everyone,) + args[5:]
    yield "all corners", (torch.zeros_like(is_edge),) + args[1:4] + (everyone,) + args[5:]
    yield "all edgelets", (torch.ones_like(is_edge),) + args[1:4] + (everyone,) + args[5:]
    yield "S = 4 k + 1", tuple(a[:(a.shape[0] - 1) // 4 * 4 - 3].contiguous() for a in args)
    px = px_init.clone()
    anchor = torch.stack([au, av], dim=-1).float()
    px[0] = anchor[0] - 20.0                     # outside from the first iteration on
    px[1] = anchor[1] + 4.0                      # the patch starts on the window's corner
    px[2] = float("nan")
    px[3, 0] = float("inf")
    yield "rows outside / on the edge / NaN", args[:3] + (px, everyone) + args[5:]
    px = px_init.clone()
    px[:, 0] = anchor[:, 0] + 4.05
    yield LEFT_EDGE, args[:3] + (px, everyone) + args[5:]


def check_align(calls, device, results, key="align_match", n_calls=2):
    assert len(calls) == n_calls, f"expected {n_calls} alignment passes, got {len(calls)}"
    worst = 0.0
    n_conv, n_left = [], []
    for args, kw in calls:
        for what, a in align_variants(args):
            got = align_cuda.align_match_cuda(*a, **kw)
            ref = align_cuda.align_match_plain(*a, **kw)
            worst = max(worst, compare_align(got, ref, f"{key} ({what})"))
            assert same_bits(got, align_cuda.align_match_cuda(*a, **kw)), \
                f"{key} ({what}): second launch differs"
            if what == "as recorded":
                n_conv.append(int((ref[2] > 0.5).sum()))
            if what == LEFT_EDGE:           # some rows are out after their first update
                first = align_cuda.align_match_plain(*a, **{**kw, "n_iter": 1})
                left = (first[0] - 4.0 - a[6].float() < 0.0) & (first[0] != a[3][:, 0])
                n_left.append(int(left.sum()))
                assert n_left[-1] > 0, f"{key}: no row left its window on iteration 1"
                assert bool((ref[0][left] == first[0][left]).all()), \
                    f"{key}: a row that left its window moved on"
        # adversarial: an empty mask returns px_init and converges nowhere
        a2 = list(args)
        a2[4] = torch.zeros_like(args[4])
        dead = align_cuda.align_match_cuda(*a2, **kw)
        assert not bool((dead[2] > 0.5).any())
        assert float((dead[:2].T - args[3]).abs().max()) <= 1e-6
        # ... and all eight outputs are the plain version's (NCC 1e-3, gradient
        # 2e-2 at px_init; chi2 and the mean are 0)
        d_dead = (dead - align_cuda.align_match_plain(*a2, **kw)).abs().amax(dim=1).tolist()
        assert d_dead[3] <= 1e-3 and max(d_dead[4:6]) <= 2e-2 and max(d_dead[6:]) == 0.0, \
            f"{key}: empty mask differs from the plain version: {d_dead}"
    args, kw = calls[0]
    s = args[5].shape[0]
    win, n_iter = kw["win"], kw["n_iter"]
    assert align_cuda.align_launch_plan(s, win) == c_plan3("hso_align_launch_plan", s, win)
    # the work this call's data needs: windows of the live rows only, and of
    # each the iterations after which the plain version's result stands
    its = align_iterations(*args, **kw)
    live = args[4]
    n_live = int(live.sum())
    evals = int((its[live] + 1).clamp(max=n_iter).sum())
    nbytes = n_live * win * win * 4 + s * (100 * 4 + 16 + 16 + 2) + 8 * s * 4
    flops = evals * 64 * 32 + s * 64 * 40
    b_ms, _ = bound(nbytes, flops)
    b_all, b_all_by = bound(s * (win * win + 100) * 4 + s * 34 + 8 * s * 4,
                     s * ((n_iter + 1) * 64 * 32 + 64 * 40))
    also = f" (also {calls[1][0][5].shape[0]})" if len(calls) > 1 else ""
    launch, _ = align_cuda.align_match_prepare(*args, **kw)
    # `ms` times the wrapper the step calls, `bound_ms` counts all S rows and
    # all iterations, as in every earlier reading of this kernel; the bare
    # launch and the bound of the work this call's data needs stand beside them
    results[key] = dict(
        max_abs_err=worst, tol=5e-3,
        shape=f"S={s}{also} win={win} n_iter={n_iter} ({n_live} rows valid)",
        converged=n_conv, rows_valid=n_live, rows_out_after_first_update=n_left,
        iterations_histogram=torch.bincount(its[live].long(), minlength=n_iter + 1).tolist(),
        ms=time_ms(lambda: align_cuda.align_match_cuda(*args, **kw), device),
        launch_ms=time_ms(launch, device),
        plain_ms=time_ms(lambda: align_cuda.align_match_plain(*args, **kw), device,
                         inner=2),
        library_ms=None, bound_ms=b_all, bound_by=b_all_by, bound_work_done_ms=b_ms)


def check_pose(calls, device, results):
    assert len(calls) == 1, f"expected 1 pose LM call, got {len(calls)}"
    args, kw = calls[0]
    got = pose_cuda.pose_lm_cuda(*args, **kw)
    ref = pose_cuda.pose_lm_plain(*args, **kw)
    d_T = se3_dist(got[0], ref[0])
    assert d_T < 5e-4, f"pose LM disagrees: {d_T}"
    chi_k, chi_p = float(got[2]), float(ref[2])
    assert abs(chi_k - chi_p) <= 0.05 * abs(chi_p) + 1e-9, f"pose chi2 {chi_k} vs {chi_p}"
    worst = float((got[0] - ref[0]).abs().max())
    # adversarial: an empty mask returns T0
    a2 = list(args)
    a2[7] = torch.zeros_like(args[7])
    for fn in (pose_cuda.pose_lm_cuda, pose_cuda.pose_lm_plain):
        assert float((fn(*a2, **kw)[0] - args[0]).abs().max()) <= 1e-6
    # adversarial: a far-off initial pose
    a3 = list(args)
    T_far = args[0].clone()
    T_far[0, 3] += 0.3
    a3[0] = T_far
    d_far = se3_dist(pose_cuda.pose_lm_cuda(*a3, **kw)[0], pose_cuda.pose_lm_plain(*a3, **kw)[0])
    assert d_far < 5e-4, f"pose LM (far-off init) disagrees: {d_far}"
    n = args[1].shape[0]
    trials = int(got[3])
    nbytes = n * 8 * 4 + 3 * n + 12 * 4 + 8 + 256
    flops = trials * n * 190 + n * 40
    b_ms, b_by = bound(nbytes, flops)
    again = pose_cuda.pose_lm_cuda(*args, **kw)
    assert all(same_bits(x, y) for x, y in zip(got, again)), \
        "pose LM: second run differs"
    launch, _ = pose_cuda.pose_lm_prepare(*args, **kw)
    results["pose_lm"] = dict(
        max_abs_err=worst, tol=5e-4, shape=f"N={n}, {trials} trials (plain: {int(ref[3])})",
        evaluations=trials + 1, n=n,
        ms=time_ms(launch, device),
        plain_ms=time_ms(lambda: pose_cuda.pose_lm_plain(*args, **kw), device,
                         inner=2),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)


def check_pack_one(calls, win, key, device, results):
    """K2 on its one recorded call at window edge ``win`` (the sweep's S seed
    slots at win 40, or ``init_seeds``' detections at win 44): the plain
    version's bits, a second launch bitwise equal."""
    found = [c for c in calls if c[0][4] == win]
    assert len(found) == 1, f"expected 1 win-{win} window pack, got {len(found)}"
    (pyr, level, au, av, win, n_levels), _ = found[0]
    pyr = [p.contiguous() for p in pyr[:n_levels]]
    for img in pyr:
        assert window_plan_of(img, win)[0], f"K2 win {win}: the aligned body should take it"
    got = window_cuda.pack_level_windows_cuda(pyr, level, au, av, win, n_levels)
    worst = hold_windows([got], [window_cuda.pack_level_windows_plain(
        pyr, level, au, av, win, n_levels)], f"pack_level_windows (win {win})")
    hold_windows([window_cuda.pack_level_windows_cuda(pyr, level, au, av, win, n_levels)],
                 [got], f"pack_level_windows (win {win}), again")
    s = level.shape[0]
    b_ms, b_by = bound(2 * s * win * win * 4 + 3 * s * 4, 0)
    results[key] = dict(
        max_abs_err=worst, tol=0.0,
        shape=f"S={s} win={win} levels={n_levels}",
        ms=time_ms(lambda: window_cuda.pack_level_windows_cuda(
            pyr, level, au, av, win, n_levels), device),
        plain_ms=time_ms(lambda: window_cuda.pack_level_windows_plain(
            pyr, level, au, av, win, n_levels), device, inner=2),
        library_ms=gather_ms(level_stack(pyr, n_levels, device), level, au, av, win, device),
        bound_ms=b_ms, bound_by=b_by)


ZMNCC_ORDER = ("windows", "ref_patch", "su0", "sv0", "dir_u", "dir_v", "n_line", "au", "av",
               "hs", "ws")


def compare_line_scores(got, ref, what):
    """Kernel result against the plain one: the sets of finite, -inf and NaN
    rows and the best step exact, scores to 2e-4.  Returns the largest score
    difference."""
    (b_k, s_k, k_k), (b_p, s_p, k_p) = got, ref
    for name, a, b in (("best", b_k, b_p), ("second", s_k, s_p)):
        assert bool((torch.isfinite(a) == torch.isfinite(b)).all()), f"{what}: finite {name}"
        assert bool((torch.isnan(a) == torch.isnan(b)).all()), f"{what}: NaN {name}"
    assert bool((k_k == k_p).all()), \
        f"{what}: best step differs on {int((k_k != k_p).sum())} rows"
    worst = 0.0
    for a, b in ((b_k, b_p), (s_k, s_p)):
        m = torch.isfinite(b)
        if bool(m.any()):
            worst = max(worst, float((a - b)[m].abs().max()))
    assert worst <= 2e-4, f"{what}: scores differ by {worst}"
    return worst


def line_work(args) -> tuple:
    """What a K6 call's data asks of the kernel: (rows with a step inside,
    map entries their lines read), by the kernel's own bounds test."""
    windows, _, su0, sv0, du, dv, n_line, au, av, hs, ws, n_steps = args
    cw = windows.shape[-1] - 7
    ks = torch.arange(n_steps, dtype=torch.float32, device=windows.device)
    su = su0[:, None] + du[:, None] * ks
    sv = sv0[:, None] + dv[:, None] * ks
    pu, pv = su + 4.0 + au[:, None].float(), sv + 4.0 + av[:, None].float()
    inside = ((ks <= n_line[:, None].float()) & (su >= 0.0) & (su <= cw - 1.0) & (sv >= 0.0)
              & (sv <= cw - 1.0) & (pu - 4.0 >= 0.0) & (pu + 4.0 <= ws[:, None].float() - 1.0)
              & (pv - 4.0 >= 0.0) & (pv + 4.0 <= hs[:, None].float() - 1.0))
    rows = torch.where(sv == torch.floor(sv), 1, 2)
    cols = torch.where(torch.floor(su) + 1.0 < cw, 2, 1)
    return int(inside.any(dim=1).sum()), int((inside * rows * cols).sum())


def check_zmncc(calls, cur_pyr, device, results, other=None):
    assert len(calls) == 1, f"expected 1 epipolar search per frame, got {len(calls)}"
    args, kw = calls[0]
    n_steps = args[11]
    s, ew = args[0].shape[0], args[0].shape[-1]
    assert ew == epipolar.EW and n_steps == 40
    assert epipolar_cuda.zmncc_launch_plan(s, ew, n_steps) == \
        c_plan3("hso_zmncc_launch_plan", s, ew, n_steps)
    got = epipolar_cuda.zmncc_line_scores_cuda(*args)
    ref = epipolar_cuda.zmncc_line_scores_plain(*args)
    worst = compare_line_scores(got, ref, "zmncc (recorded call)")
    n_finite = int(torch.isfinite(ref[0]).sum())
    n_live, n_entries = line_work(args)
    assert n_live >= n_finite
    again = epipolar_cuda.zmncc_line_scores_cuda(*args)
    for a, b in zip(got, again):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), "zmncc: second run differs"
    vs_other = None
    if other is not None:                   # another version of the kernel, same call
        with _cuda_build.using_lib(other):
            got_o = epipolar_cuda.zmncc_line_scores_cuda(*args)
        compare_line_scores(got, got_o, "zmncc (this version against the other)")
        m = torch.isfinite(got_o[0])
        vs_other = float((got[0] - got_o[0])[m].abs().max())

    # a wider window (EW 48) on seeded noise windows with the adversarial rows:
    # low contrast, a segment wholly outside the window, a segment ending on
    # the last map column, a window at the image corner, a zero direction; a
    # non-finite window entry (rows 9, 10: ON or OFF the line, it must turn
    # its row, and only it, into NaN); a huge entry that overflows (row 11:
    # NaN from both) and one that does not (row 12, off the line: finite from
    # both, through the kernel's whole-map scan); and the upper half of the
    # rows with every step outside the window: (-inf, -inf, 0), the window unread
    case = testing.line_score_cases(s=256, ew=48, n_steps=n_steps, seed=0)
    case["windows"][9, 3, 3] = np.inf
    for row in (10, 11, 12):                # a horizontal segment in the window's middle
        case["su0"][row], case["sv0"][row] = 20.0, 20.3
        case["dir_u"][row], case["dir_v"][row], case["n_line"][row] = 1.0, 0.0, 10
    case["windows"][10, 0, 0] = np.nan
    case["windows"][11, 5, 5] = 1e20
    case["windows"][12, 0, 0] = 1e15
    case["su0"][128:], case["dir_u"][128:], case["dir_v"][128:] = -60.0, -1.0, 0.0
    a48 = [torch.as_tensor(case[k], device=device) for k in ZMNCC_ORDER]
    got48 = epipolar_cuda.zmncc_line_scores_cuda(*a48, n_steps)
    ref48 = epipolar_cuda.zmncc_line_scores_plain(*a48, n_steps)
    worst = max(worst, compare_line_scores(got48, ref48, "zmncc (EW 48)"))
    again48 = epipolar_cuda.zmncc_line_scores_cuda(*a48, n_steps)
    assert all(same_bits(a, b) for a, b in zip(got48, again48)), "zmncc (EW 48): second run"
    for out in (got48, ref48):
        assert bool(torch.isneginf(out[0][1])) and bool(torch.isneginf(out[1][1]))
        assert int(out[2][1]) == 0
        assert bool(torch.isneginf(out[0][128:]).all()) and bool(torch.isneginf(out[1][128:]).all())
        assert not bool(out[2][128:].any())
        assert bool(torch.isnan(out[0][[9, 10, 11]]).all()) and int(torch.isnan(out[0]).sum()) == 3
        assert bool(torch.isfinite(out[0][12]))
    assert line_work(tuple(a48) + (n_steps,))[0] <= 127

    # the search around it on the real pyramid, 48-px windows: a window clipped
    # at the image corner, a zero-length segment, a dead slot
    pb = testing.epipolar_problem([tuple(p.shape) for p in cur_pyr[:3]], s=48, seed=7)
    tt = lambda a: torch.as_tensor(a, device=device)   # noqa: E731
    windows, anchors, img_hw = epipolar.pack_level_windows(
        cur_pyr, tt(pb["level"]), tt(pb["center"][:, 0]), tt(pb["center"][:, 1]), 48, 3)
    ref_patch = torch.stack([tt(testing.bilinear_patch(
        cur_pyr[int(l)].cpu().numpy(), float(c[0]), float(c[1]), size=8))
        for l, c in zip(pb["level"], pb["center"])])
    sargs = (windows, anchors, img_hw, ref_patch, tt(pb["px_far"]), tt(pb["px_close"]),
             tt(pb["valid"]))
    out_k = epipolar.epipolar_zmncc_search(*sargs)
    with patched([(epipolar, "zmncc_line_scores", epipolar_cuda.zmncc_line_scores_plain)]):
        out_p = epipolar.epipolar_zmncc_search(*sargs)
    assert torch.equal(out_k["ok"], out_p["ok"]) and torch.equal(out_k["n_line"], out_p["n_line"])
    assert int(out_p["ok"].sum()) > 20 and not bool(out_p["ok"][2])
    okm = out_p["ok"]
    assert float((out_k["px_best"] - out_p["px_best"])[okm].abs().max()) <= 1e-4
    worst = max(worst, float((out_k["score_best"] - out_p["score_best"])[okm].abs().max()))
    assert worst <= 2e-4

    # `bound_ms` is the dense map over all S rows, as in every earlier reading
    # of this kernel; beside it the bound of what this call's data needs: the
    # windows of the rows with a step inside and the map entries their lines
    # read (about 320 operations each: 64 products and their sum, two 64-term
    # box sums)
    nbytes = n_live * (ew * ew + 64) * 4 + s * 9 * 4 + s * 3 * 4
    flops = n_entries * 320 + n_live * (n_steps * 30 + 400)
    b_ms, _ = bound(nbytes, flops)
    ow = ew - 7
    b_all, b_all_by = bound(s * (ew * ew + 64) * 4 + s * 12 * 4,
                     s * (ew * ow * 22 + ow * ow * (14 + 127 + 8) + n_steps * 30))
    launch, _ = epipolar_cuda.zmncc_line_scores_prepare(*args)
    results["zmncc_line_scores"] = dict(
        max_abs_err=worst, tol=2e-4,
        shape=f"S={s} EW={ew} n_steps={n_steps} ({n_live} rows with a step inside, "
        f"{n_finite} with a finite best, {n_entries} map entries read; also S=256 EW=48)",
        rows_live=n_live, map_entries_read=n_entries, vs_other_version=vs_other,
        ms=time_ms(lambda: epipolar_cuda.zmncc_line_scores_cuda(*args), device),
        launch_ms=time_ms(launch, device),
        plain_ms=time_ms(lambda: epipolar_cuda.zmncc_line_scores_plain(*args), device,
                         inner=2),
        library_ms=None, bound_ms=b_all, bound_by=b_all_by, bound_work_done_ms=b_ms)


# ------------------------------------------------------------------ latency phase
PROBES = {"block_barrier": 0, "cluster_barrier": 1, "block_sums_37": 2, "block_sums_28": 3,
          "coarse_step": 4, "pose_step": 5, "cluster_sum_37": 6}


def probe_us(kind: str, threads: int, cluster: int, device, rounds: int = 2000) -> float:
    """Microseconds per round of one latency probe (``csrc/probe.cu``): the
    difference of two loop lengths over the extra rounds, so that the launch
    and the set-up drop out."""
    out = torch.zeros((1,), device=device)
    fn = _cuda_build.lib().hso_probe_latency
    stream = torch.cuda.current_stream(device).cuda_stream

    def run(n):
        _cuda_build.check(fn(PROBES[kind], threads, cluster, n, out.data_ptr(), stream),
                          "hso_probe_latency")

    t1 = time_ms(lambda: run(rounds), device, inner=1, n_timed=7, n_warm=2)
    t2 = time_ms(lambda: run(2 * rounds), device, inner=1, n_timed=7, n_warm=2)
    return (t2 - t1) / rounds * 1e3


def latency_floor(results, device) -> dict:
    """The card's figures for the pieces of one serial evaluation, and the
    floor they put under K3 (per level, at the block size its plan chose) and
    K5: evaluations x (reduction + barrier + scalar step).  K3's reduction is
    the block's sums plus the cluster-wide sum (which holds the cluster
    barrier); K5's is the block's sums plus one block barrier."""
    cluster = coarse_cuda.CLUSTER
    k5_threads = (results["pose_lm"]["n"] + 31) // 32 * 32
    us = {"k5_block_sums": probe_us("block_sums_28", k5_threads, 1, device),
          "k5_scalar_step": probe_us("pose_step", k5_threads, 1, device),
          "k5_block_barrier": probe_us("block_barrier", k5_threads, 1, device)}
    per_eval = {"k5": us["k5_block_sums"] + us["k5_block_barrier"] + us["k5_scalar_step"]}
    for threads in sorted({r["threads"] for k, r in results.items() if k.startswith("coarse")}):
        piece = {"block_barrier": probe_us("block_barrier", threads, 1, device),
                 "cluster_barrier": probe_us("cluster_barrier", threads, cluster, device),
                 "block_sums": probe_us("block_sums_37", threads, 1, device),
                 "cluster_sum": probe_us("cluster_sum_37", threads, cluster, device),
                 "scalar_step": probe_us("coarse_step", threads, 1, device)}
        us.update({f"k3_{name}@{threads}": v for name, v in piece.items()})
        per_eval[f"k3@{threads}"] = (piece["block_sums"] + piece["cluster_sum"]
                                     + piece["scalar_step"])
    floors = {}
    for key, r in results.items():
        if key.startswith("coarse_level_ic"):
            floors[key] = r["evaluations"] * per_eval[f"k3@{r['threads']}"] * 1e-3
        elif key == "pose_lm":
            floors[key] = r["evaluations"] * per_eval["k5"] * 1e-3
        else:
            continue
        r["latency_floor_ms"] = floors[key]
    return dict(us_per_round=us, k3_cluster=cluster, k5_threads=k5_threads,
                us_per_evaluation=per_eval, latency_floor_ms=floors)


# ------------------------------------------------------------------ track phase
def initial_state(cam, cfg, device):
    """The state both steps start from (the tracking step ignores the seed
    members), and the checkpoint's bookkeeping."""
    (snap, prev_pyr, grad_mean, intensity, exposure, T_prev, prev_obs, frame_count, seeds,
     seed_ring, batch_counter, px_error_angle) = checkpoint.frame_state_from_checkpoint(
        BOOT_NPZ, cam, cfg, device)
    p = snap["pos_w"].shape[0]
    state = dict(snap=snap, prev_pyr=prev_pyr, prev_grad_mean=grad_mean,
                 prev_intensity=intensity, exposure_prev=exposure, T_prev=T_prev,
                 prev_obs=prev_obs, acc=torch.zeros((2, p), dtype=torch.int32, device=device),
                 T_rel=torch.as_tensor(se3np.identity().astype(np.float32), device=device),
                 seeds=seeds, px_error_angle=px_error_angle)
    return state, dict(frame_count=frame_count, seed_ring=seed_ring,
                       batch_counter=batch_counter)


def run_one(step, state, img, whole: bool = False):
    head = (img, state["prev_pyr"], state["prev_grad_mean"], state["T_prev"],
            state["prev_obs"], state["prev_intensity"], state["exposure_prev"],
            state["T_rel"], state["snap"])
    if whole:
        return step(*head, state["seeds"], state["px_error_angle"], state["acc"])
    return step(*head, state["acc"])


def advance(state, out):
    """Feed a step's result forward (map frozen: ``snap`` stays)."""
    nxt = dict(state)
    nxt.update(prev_pyr=out["data"]["pyr"], prev_grad_mean=out["data"]["grad_mean"],
               prev_intensity=out["data"]["intensity_mean"], exposure_prev=out["exposure"],
               T_prev=out["T_new"], prev_obs=out["obs_next"], acc=out["acc"])
    if "seeds" in out:
        nxt["seeds"] = out["seeds"]
    return nxt


def run_track(step, state, frames, device, whole: bool = False):
    """Run the frames through a step; returns (per-frame records, ms per
    frame, the state after the last frame)."""
    recs, ms = [], []
    for img in frames:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = run_one(step, state, img, whole)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        rec = dict(T_new=out["T_new"].cpu().numpy(), packed=out["packed"].cpu().numpy(),
                   acc=out["acc"].cpu().numpy(), px=out["px"].cpu().numpy(),
                   n_inliers=int(out["n_inliers"]), n_matches=int(out["n_matches"]),
                   used_fc=bool(out["used_fc"]), exposure=float(out["exposure"]))
        if whole:
            rec.update(kf_pack=out["kf_pack"].cpu().numpy(),
                       n_seeds_updated=int(out["n_seeds_updated"]),
                       seed_matched=out["seed_matched"].cpu().numpy(),
                       mu=out["seeds"]["mu"].cpu().numpy(),
                       sigma2=out["seeds"]["sigma2"].cpu().numpy(),
                       obs_count=out["seeds"]["obs_count"].cpu().numpy(),
                       seeds_valid=out["seeds"]["valid"].cpu().numpy())
        recs.append(rec)
        state = advance(state, out)
    return recs, ms, state


def check_run(recs, gt, what):
    """The gates of a tracked run: finite poses, inliers, trajectory error."""
    assert all(np.isfinite(r["T_new"]).all() and r["T_new"].shape == (3, 4) for r in recs)
    min_inl = min(r["n_inliers"] for r in recs)
    assert min_inl >= 50, f"{what}: a frame kept only {min_inl} inliers"
    rmse = track_ate(recs, gt)
    assert rmse < 0.10, f"{what}: ATE RMSE {rmse:.4f} m exceeds the 0.10 m gate"
    return min_inl, rmse


def assert_same_run(a_recs, b_recs, keys, what):
    for k, (a, b) in enumerate(zip(a_recs, b_recs)):
        for key in keys:
            assert np.array_equal(a[key], b[key], equal_nan=True), \
                f"{what}: frame {k} differs in {key}"


# ------------------------------------------------------------------ seeds phase
def detections_from_keyframe(z, kf: int) -> dict:
    """A keyframe's stored observation table as a detection set (numpy)."""
    pre = f"kf{kf}_obs_"
    return dict(px=z[pre + "px"], level=z[pre + "level"], species=z[pre + "species"],
                grad=z[pre + "grad"], valid=z[pre + "valid"], f=z[pre + "f"])


def keyframe_detections(book) -> tuple:
    """The last keyframe of the checkpoint: its observation table as a
    detection set, its pyramid (numpy) and its slot in the seed ring."""
    z = np.load(BOOT_NPZ, allow_pickle=False)
    last_kf = int(z["kf_count"]) - 1
    det_np = detections_from_keyframe(z, last_kf)
    kf_pyr_np = [z[f"lastkf_pyr_{l}"] for l in range(3)]
    host_slot = int(np.nonzero(book["seed_ring"] == last_kf)[0][0])
    return det_np, kf_pyr_np, host_slot


def record_init_seeds(state0, book, out0, device) -> list:
    """The window gathers ``init_seeds`` makes when it fills the seed table
    from the last keyframe's detections (recorded calls of K2's dispatcher)."""
    det_np, kf_pyr_np, host_slot = keyframe_detections(book)
    rec = Recorder(window_cuda.pack_level_windows_gather)
    with patched([(epipolar, "pack_level_windows_gather", rec)]):
        depth_filter.init_seeds(
            state0["seeds"], {k: torch.as_tensor(det_np[k], device=device)
                              for k in ("px", "level", "species", "grad", "valid")},
            tuple(torch.as_tensor(p, device=device) for p in kf_pyr_np),
            torch.as_tensor(det_np["f"], device=device), host_slot, book["batch_counter"] + 1,
            float(out0["depth_mean"]), float(out0["depth_min"]), 200.0)
    return rec.calls


def seed_life(seeds_np, det_np, pyr_np, host_slot, batch_id, depth_mean, depth_min,
              ring_T_np, ring_exp_np, sweeps, px_error_angle, cam, device):
    """``init_seeds`` into the free slots, one sweep per (image, pose,
    exposure) of ``sweeps``, then ``harvest_and_prune``; all on ``device``
    from numpy state.  Returns numpy results."""
    tt = lambda a: torch.as_tensor(a, device=device)   # noqa: E731
    seeds = checkpoint.seeds_from_numpy(seeds_np, device)
    det = {k: tt(det_np[k]) for k in ("px", "level", "species", "grad", "valid")}
    pyr = tuple(tt(p) for p in pyr_np)
    seeds = depth_filter.init_seeds(seeds, det, pyr, tt(det_np["f"]), host_slot, batch_id,
                                    depth_mean, depth_min, 200.0)
    after_init = checkpoint.seeds_to_numpy(seeds)
    ring_T, ring_exp = tt(ring_T_np), tt(ring_exp_np)
    n_updated = []
    for img, T_new, exposure in sweeps:
        data = build_frame_pyramids(img, device=device)
        seeds, stats = depth_filter.update_seeds(
            seeds, ring_T, ring_exp, data["pyr"], data["sobel_x"], data["sobel_y"],
            tt(T_new), exposure, px_error_angle, cam)
        n_updated.append(int(stats["n_updated"]))
    swept = checkpoint.seeds_to_numpy(seeds)
    seeds, bundle = depth_filter.harvest_and_prune(seeds, batch_id, ring_T,
                                                   focal=float(cam.focal_mean))
    idx = torch.nonzero(bundle[:, 0] > 0.5)[:, 0]
    rows = depth_filter.gather_seed_windows(seeds["host_win"], seeds["host_anchor"], idx)
    return dict(after_init=after_init, swept=swept, n_updated=n_updated,
                bundle=bundle.cpu().numpy(), valid_after=seeds["valid"].cpu().numpy(),
                harvest_rows=rows.cpu().numpy())


def track_ate(recs, gt_poses) -> float:
    est = np.stack([se3np.translation(se3np.inv(se3np.normalize(r["T_new"].astype(np.float64))))
                    for r in recs])
    gt = np.stack([se3np.translation(se3np.inv(T)) for T in gt_poses])
    return ate(est, gt, with_scale=True).rmse


def kernel_resources() -> dict:
    """Registers, stack, spills and static shared memory of K1 and K2 (each
    window-edge instance), K3 (both instances), K4, K5 and K6, as ``ptxas -v``
    printed them in the build."""
    names = {f"{k}_windows_kernelILi{w}E": f"{k}_windows_kernel<{w or 'any'}>"
             for k in ("extract", "pack_level") for w in (24, 40, 44, 0)}
    names.update({"coarse_level_ic_kernelILb1": "coarse_level_ic_kernel<windows resident>",
             "coarse_level_ic_kernelILb0": "coarse_level_ic_kernel<windows in global memory>",
             "pose_lm_kernel": "pose_lm_kernel",
             "align_match_kernel": "align_match_kernel",
             "zmncc_line_kernel": "zmncc_line_kernel"})
    found = {}
    for src in ("window.cu", "coarse.cu", "pose.cu", "align.cu", "epipolar.cu"):
        for entry, res in _cuda_build.kernel_resources(_cuda_build.BUILD_LOG[src]).items():
            for part, name in names.items():
                if part in entry:
                    found[name] = res
    assert len(found) == len(names), f"ptxas reported {sorted(found)}"
    return found


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other-csrc", default="",
                    help="another version of hso_tpu_torch/csrc to hold K6 against")
    cli = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0].strip()
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(), card=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):      # ptxas -v is read, not shown
        _cuda_build.build(verbose=True)
    _cuda_build.lib()
    emit("build", seconds=round(time.perf_counter() - t0, 2),
         library=os.path.relpath(_cuda_build.build(), ROOT), resources=kernel_resources(),
         launch_plans=check_launch_plans())
    other = None
    if cli.other_csrc:
        other = _cuda_build.load(_cuda_build.build(csrc_dir=os.path.abspath(cli.other_csrc)))

    cam, cfg = bench_camera(), Config()
    track_step, grid, n_obs_pad = build_step(cam, cfg, device)
    frame_step, _, _ = build_step(cam, cfg, device, whole=True)
    state0, book = initial_state(cam, cfg, device)
    frame_count = book["frame_count"]
    poses = trajectory(frame_count + N_FRAMES)
    gt = poses[frame_count:frame_count + N_FRAMES]
    scene = bench_scene(cam)
    frames = [scene.render(T) for T in gt]
    det_np, kf_pyr_np, host_slot = keyframe_detections(book)
    n_slots = int(state0["seeds"]["valid"].shape[0])

    # ---- kernels: each against its plain version at the main path's shapes
    results = {}
    rec, out0 = capture_kernel_inputs(frame_step, state0, frames[0])
    assert not out0["used_fc"], "frame 0 took the FC branch: no K3 inputs to check"
    check_windows(rec["windows"], rec["pack"], out0["data"]["pyr"], device, results)
    check_coarse(rec["coarse"], device, results)
    check_align(rec["align"], device, results)
    check_pose(rec["pose"], device, results)
    check_zmncc(rec["zmncc"], out0["data"]["pyr"], device, results, other)
    check_pack_one(rec["pack"], epipolar.EW, "pack_level_windows@sweep", device, results)
    check_align(rec["seed_align"], device, results, key="align_match@sweep", n_calls=1)
    seed_calls = record_init_seeds(state0, book, out0, device)
    check_pack_one(seed_calls, SEED_WIN, "pack_level_windows@seed", device, results)
    torch.cuda.synchronize(device)
    latency = latency_floor(results, device)
    for name, r in results.items():
        emit("kernels", name=name, card=smi, **r)
    emit("latency", card=smi, **latency)

    # ---- track: the tracking half, counters set to 0 just before, read just after
    zero_counters()
    recs_t, ms_t, _ = run_track(track_step, state0, frames, device)
    launches_t = read_counters()
    n_ic = sum(not r["used_fc"] for r in recs_t)
    for name in TRACK_KERNELS:
        assert launches_t[name] > 0, f"kernel {name} was never launched on the track path"
    assert launches_t["zmncc_line_scores"] == 0
    min_inl_t, rmse_t = check_run(recs_t, gt, "track")

    # second run: bitwise equal
    recs_t2, _, _ = run_track(track_step, state0, frames, device)
    assert_same_run(recs_t, recs_t2, ("T_new", "packed", "acc", "px"), "track, second run")

    # frame 1 with the plain versions on the card
    with plain_kernels():
        before = read_counters()
        ref1 = run_one(track_step, state0, frames[0])
        assert read_counters() == before, "the plain run launched a kernel"
    d_plain = se3_dist(torch.as_tensor(recs_t[0]["T_new"]), ref1["T_new"])
    assert d_plain < 1e-3, f"frame 1: kernels and plain versions differ by {d_plain}"

    emit("track", card=smi, frames=N_FRAMES, first_frame=frame_count, grid=list(grid),
         n_obs_pad=n_obs_pad, points=int(state0["snap"]["pos_w"].shape[0]),
         ms_per_frame_median=statistics.median(ms_t), ms_per_frame_first=ms_t[0],
         ic_frames=n_ic, fc_frames=N_FRAMES - n_ic, launches=launches_t,
         launches_per_frame={k: v / N_FRAMES for k, v in launches_t.items()},
         min_inliers=min_inl_t, min_matches=min(r["n_matches"] for r in recs_t),
         ate_rmse_m=rmse_t, frame1_vs_plain=d_plain, second_run_bitwise_equal=True)

    # ---- frame: the whole step (the main path), counters set to 0 just
    # before, read just after; call sites tallied by window edge
    ctx, tallies = shape_tallies()
    with ctx:
        zero_counters()
        recs_f, ms_f, state_end = run_track(frame_step, state0, frames, device, whole=True)
        launches_f = read_counters()
    for name in FRAME_KERNELS:
        assert launches_f[name] > 0, f"kernel {name} was never launched on the main path"
    for name, tally in tallies.items():
        assert sum(tally.counts.values()) == launches_f[name], \
            f"{name}: call sites {tally.counts} but {launches_f[name]} launches"
    assert launches_f["zmncc_line_scores"] == N_FRAMES
    assert tallies["extract_windows"].counts == {24: 4 * N_FRAMES}
    assert launches_f["extract_windows"] == 4 * N_FRAMES
    assert tallies["pack_level_windows"].counts == {24: 2 * N_FRAMES, epipolar.EW: N_FRAMES}
    assert tallies["align_match"].counts == {24: 2 * N_FRAMES, epipolar.EW: N_FRAMES}
    assert launches_f["pack_level_windows"] == launches_f["align_match"] == 3 * N_FRAMES
    n_ic_f = sum(not r["used_fc"] for r in recs_f)
    assert tallies["coarse_level_ic"].counts == {h: n_ic_f for h in (30, 60, 120, 240)}
    min_inl_f, rmse_f = check_run(recs_f, gt, "frame")
    # with a frozen map the sweep feeds nothing back into tracking: the poses
    # of the two paths must be the same bits
    assert_same_run(recs_f, recs_t, ("T_new", "acc", "px"), "frame vs track path")
    seeds_updated = sum(r["n_seeds_updated"] for r in recs_f)
    assert seeds_updated > 0, "the sweep updated no seed in 24 frames"
    valid0 = state0["seeds"]["valid"].cpu().numpy()
    assert all(np.array_equal(r["seeds_valid"], valid0) for r in recs_f), \
        "the sweep changed which seed slots are live"
    assert all(r["packed"][19] == r["n_seeds_updated"] for r in recs_f)
    p_rows = int(state0["snap"]["pos_w"].shape[0])
    assert recs_f[0]["kf_pack"].shape == (grid[1] * grid[2] * 11 + 2 * p_rows + 3 * n_slots,)

    # second run: bitwise equal
    frame_keys = ("T_new", "packed", "kf_pack", "acc", "px", "mu", "sigma2", "obs_count",
                  "seed_matched")
    recs_f2, _, _ = run_track(frame_step, state0, frames, device, whole=True)
    assert_same_run(recs_f, recs_f2, frame_keys, "frame, second run")
    vs_other = None
    if other is not None:
        # the same frames on the other version of the kernels, K1 as one launch
        # per image (the other version may have no multi-job entry)
        from hso_tpu_torch.track import coarse_tracker

        def one_launch_a_job(jobs, win):
            return [window_cuda.extract_windows(img, au, av, win) for img, au, av in jobs]

        with _cuda_build.using_lib(other), \
                patched([(coarse_tracker, "extract_windows_multi", one_launch_a_job)]):
            recs_o, _, _ = run_track(frame_step, state0, frames, device, whole=True)
        assert_same_run(recs_f, recs_o, frame_keys, "frame, this version against the other")
        vs_other = "bitwise equal"

    # frame 1 with every kernel routed to its plain version, on the card
    with plain_kernels():
        before = read_counters()
        ref1 = run_one(frame_step, state0, frames[0], whole=True)
        assert read_counters() == before, "the plain run launched a kernel"
    d_plain_f = se3_dist(torch.as_tensor(recs_f[0]["T_new"]), ref1["T_new"])
    assert d_plain_f < 1e-3, f"frame 1: kernels and plain versions differ by {d_plain_f}"
    m_k = recs_f[0]["seed_matched"]
    m_p = ref1["seed_matched"].cpu().numpy()
    n_flip = int((m_k != m_p).sum())
    assert n_flip <= 4, f"frame 1: {n_flip} seeds matched by one of kernels/plain only"
    both = m_k & m_p
    assert both.sum() > 50
    d_mu = float(np.abs(recs_f[0]["mu"] - ref1["seeds"]["mu"].cpu().numpy())[both].max())
    assert d_mu <= 1e-3, f"frame 1: seed mu differs by {d_mu} between kernels and plain"

    emit("frame", card=smi, frames=N_FRAMES, first_frame=frame_count, seed_slots=n_slots,
         seeds_valid=int(valid0.sum()),
         ms_per_frame_median=statistics.median(ms_f), ms_per_frame_first=ms_f[0],
         track_ms_per_frame_median=statistics.median(ms_t),
         launches=launches_f,
         launches_per_frame={k: v / N_FRAMES for k, v in launches_f.items()},
         launches_by_window={k: {str(w): n for w, n in t.counts.items()}
                             for k, t in tallies.items()},
         min_inliers=min_inl_f, ate_rmse_m=rmse_f, t_new_equals_track_path=True,
         seeds_updated_total=seeds_updated,
         seeds_updated_per_frame=[r["n_seeds_updated"] for r in recs_f],
         frame1_vs_plain=d_plain_f, frame1_matched_flips=n_flip, frame1_mu_vs_plain=d_mu,
         second_run_bitwise_equal=True, vs_other_version=vs_other)

    # ---- fc_frame: one frame forced through the forward-compositional branch
    # of the coarse tracker (the step picks it when the gradient mean rose by
    # more than 0.5 over the previous frame's, so a previous mean far below
    # forces it), on the card and on the CPU from the same state; tolerances of
    # tests/test_torch_coarse.py (pose 1e-3, exposure ratio 1e-3)
    state_fc = dict(state0, prev_grad_mean=-1e6)
    zero_counters()
    out_fc = run_one(frame_step, state_fc, frames[0], whole=True)
    torch.cuda.synchronize(device)
    launches_fc = read_counters()
    cpu = torch.device("cpu")
    cpu_step, _, _ = build_step(cam, cfg, cpu, whole=True)
    cpu_state, _ = initial_state(cam, cfg, cpu)
    cpu_fc = run_one(cpu_step, dict(cpu_state, prev_grad_mean=-1e6), frames[0], whole=True)
    assert read_counters() == launches_fc, "the CPU run launched a kernel"
    assert bool(out_fc["used_fc"]) and bool(cpu_fc["used_fc"]), "the FC branch was not taken"
    assert launches_fc["coarse_level_ic"] == 0, "an FC frame launched the IC kernel"
    d_fc = se3_dist(out_fc["T_new"], cpu_fc["T_new"])
    d_exp = abs(float(out_fc["exposure"]) - float(cpu_fc["exposure"]))
    assert d_fc < 1e-3 and d_exp < 1e-3, f"FC frame: card and CPU differ: dT={d_fc} da={d_exp}"
    d_ic = se3_dist(out_fc["T_new"], torch.as_tensor(recs_f[0]["T_new"]))
    assert d_ic < 1e-2, f"FC and IC disagree on frame 1: {d_ic}"
    assert int(out_fc["n_inliers"]) >= 50 and int(cpu_fc["n_inliers"]) >= 50
    emit("fc_frame", card=smi, used_fc=True, t_new_card_vs_cpu=d_fc, exposure_card_vs_cpu=d_exp,
         t_new_fc_vs_ic=d_ic, n_inliers=int(out_fc["n_inliers"]),
         n_inliers_cpu=int(cpu_fc["n_inliers"]), launches=launches_fc)

    # ---- seeds: the seed table's life on the card and on the CPU from the
    # same numpy state: fill the free slots from the last keyframe's
    # observation table, three sweeps, harvest
    seeds_np = checkpoint.seeds_to_numpy(state_end["seeds"])
    ring_T_np = state0["snap"]["ring_T"].cpu().numpy()
    ring_exp_np = state0["snap"]["ring_exp"].cpu().numpy()
    sweeps = [(frames[k], recs_f[k]["T_new"], recs_f[k]["exposure"]) for k in (8, 16, 23)]
    life_args = (seeds_np, det_np, kf_pyr_np, host_slot, book["batch_counter"] + 1,
                 float(out0["depth_mean"]), float(out0["depth_min"]), ring_T_np, ring_exp_np,
                 sweeps, state0["px_error_angle"], cam)
    ctx, tallies_s = shape_tallies()
    with ctx:
        zero_counters()
        life_k = seed_life(*life_args, device)
        launches_s = read_counters()
    assert tallies_s["pack_level_windows"].counts == {SEED_WIN: 1, epipolar.EW: len(sweeps)}
    assert launches_s["extract_windows"] == 0 and launches_s["pack_level_windows"] == 1 + len(sweeps)
    assert launches_s["zmncc_line_scores"] == len(sweeps)
    life_c = seed_life(*life_args, torch.device("cpu"))
    assert read_counters() == launches_s, "the CPU run launched a kernel"
    for k in ("valid", "host", "batch_id", "level", "species", "host_anchor", "temp_point"):
        assert np.array_equal(life_k["after_init"][k], life_c["after_init"][k]), \
            f"init_seeds: {k} differs between the card and the CPU"
    assert np.array_equal(life_k["after_init"]["host_win"], life_c["after_init"]["host_win"])
    n_new = int(life_k["after_init"]["valid"].sum() - seeds_np["valid"].sum())
    assert n_new == min(int(det_np["valid"].sum()), int((~seeds_np["valid"]).sum())) > 0
    bk, bc = life_k["bundle"], life_c["bundle"]
    flag_flips = int((bk[:, :2] != bc[:, :2]).sum())
    assert flag_flips <= 2, f"harvest flags differ on {flag_flips} entries"
    assert np.array_equal(bk[:, 2], bc[:, 2]) and np.array_equal(bk[:, 8:10], bc[:, 8:10])
    m_both = (life_k["swept"]["n_updates"] == life_c["swept"]["n_updates"]) \
        & life_k["swept"]["valid"]
    assert m_both.mean() >= 0.98 * life_k["swept"]["valid"].mean()
    d_mu_s = float(np.abs(life_k["swept"]["mu"] - life_c["swept"]["mu"])[m_both].max())
    assert d_mu_s <= 2e-3, f"seed mu differs by {d_mu_s} between the card and the CPU"
    assert sum(life_k["n_updated"]) > 0
    emit("seeds", card=smi, slots=n_slots, valid_before=int(seeds_np["valid"].sum()),
         detections=int(det_np["valid"].sum()), initialised=n_new,
         valid_after_init=int(life_k["after_init"]["valid"].sum()),
         updated_per_sweep=life_k["n_updated"], updated_per_sweep_cpu=life_c["n_updated"],
         converged=int((bk[:, 0] > 0.5).sum()), stale=int((bk[:, 1] > 0.5).sum()),
         valid_after_harvest=int(life_k["valid_after"].sum()),
         harvest_rows=list(life_k["harvest_rows"].shape),
         harvest_flag_flips_vs_cpu=flag_flips, mu_vs_cpu=d_mu_s, launches=launches_s)

    def launches_of(key):
        """A results key is ``kernel`` or ``kernel@where``: launches of that
        kernel at that entry's window edge, on the path that runs it."""
        name, _, where = key.partition("@")
        if where == "seed":
            return name, tallies_s[name].counts[SEED_WIN]
        if where == "sweep":
            return name, tallies[name].counts[epipolar.EW]
        if where.startswith("level"):
            return name, tallies[name].counts[cam.height >> int(where[5:])]
        if name in tallies:
            return name, tallies[name].counts[24]
        return name, launches_f[name]

    kernels = []
    for key, r in results.items():
        if key == "coarse_level_ic@global-windows":
            continue          # a forced shape, not one of the main path: `kernels` phase only
        name, n = launches_of(key)
        kernels.append(dict(
            name=name, shape=r["shape"], route="cuda", source=KERNEL_META[name][0],
            replaces=KERNEL_META[name][1], launches=n, max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            **{k: r[k] for k in ("latency_floor_ms", "launch_ms", "bound_work_done_ms")
               if k in r}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Drives the port's main path — the tracking half of the per-frame step,
``hso_tpu_torch.pipeline.fused_step.make_track_step`` — at full width
(pinhole 640×480, default ``Config``, 336 grid cells, 4096 point rows with
24×24 windows, state resumed from ``artifacts/bench_boot.npz``) over 24
rendered frames, after building every CUDA kernel from the sources in
``hso_tpu_torch/csrc`` and holding each against its plain PyTorch version
on the card.  Needs one CUDA device; exits non-zero without one.  Imports
nothing of JAX.

Phases (one JSON line each): ``device``, ``build``, ``kernels`` (one line per
kernel), ``track``; then the ``{"kernels": [...]}`` summary and, last, the
``{"ok": true, "device": {...}}`` line.  Any failed check raises.
"""

from __future__ import annotations

import contextlib
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
from hso_tpu_torch.ops import align_cuda, window_cuda  # noqa: E402
from hso_tpu_torch.ops.gatherless import clip_anchor  # noqa: E402
from hso_tpu_torch.pipeline.fused_step import make_track_step  # noqa: E402
from hso_tpu_torch.track import coarse_cuda, pose_cuda  # noqa: E402
from hso_tpu_torch.utils.checkpoint import track_state_from_checkpoint  # noqa: E402
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
}
KERNEL_META = {
    "extract_windows": ("hso_tpu_torch/csrc/window.cu", "hso_tpu/ops/window_pallas.py:119"),
    "pack_level_windows": ("hso_tpu_torch/csrc/window.cu", "hso_tpu/ops/window_pallas.py:173"),
    "coarse_level_ic": ("hso_tpu_torch/csrc/coarse.cu", "hso_tpu/track/coarse_pallas.py:300"),
    "align_match": ("hso_tpu_torch/csrc/align.cu", "hso_tpu/ops/align_pallas.py:228"),
    "pose_lm": ("hso_tpu_torch/csrc/pose.cu", "hso_tpu/track/pose_pallas.py:233"),
}


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


def build_step(cam, cfg, device):
    grid = grid_of(cam, cfg)
    n_obs_pad = max(cfg.n_fts_max, grid[1] * grid[2])
    step = make_track_step(
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
    from hso_tpu_torch.ops import epipolar
    from hso_tpu_torch.track import coarse_tracker, matcher, pose_optimizer

    return patched([
        (coarse_tracker, "extract_windows", window_cuda.extract_windows_plain),
        (epipolar, "pack_level_windows_gather", window_cuda.pack_level_windows_plain),
        (matcher, "align_match", align_cuda.align_match_plain),
        (coarse_tracker, "coarse_level_ic", coarse_cuda.coarse_level_ic_plain),
        (pose_optimizer, "pose_lm", pose_cuda.pose_lm_plain),
    ])


def capture_kernel_inputs(step, state, img):
    """Run one step with recorders on the K3/K4/K5 dispatchers and return
    the recorded calls: the shapes and data the main path gives them."""
    from hso_tpu_torch.track import coarse_tracker, matcher, pose_optimizer

    rec3 = Recorder(coarse_cuda.coarse_level_ic)
    rec4 = Recorder(align_cuda.align_match)
    rec5 = Recorder(pose_cuda.pose_lm)
    with patched([(coarse_tracker, "coarse_level_ic", rec3),
                  (matcher, "align_match", rec4),
                  (pose_optimizer, "pose_lm", rec5)]):
        out = run_one(step, state, img)
    return rec3.calls, rec4.calls, rec5.calls, out


# ------------------------------------------------------------------ kernels phase
def check_windows(cur_pyr, device, results):
    g = torch.Generator(device="cpu").manual_seed(0)
    win, n = 24, 336

    # K1 at every coarse level: corner anchors + random interior anchors
    worst = 0.0
    for level in (4, 3, 2, 1):
        img = cur_pyr[level]
        h, w = img.shape
        au = torch.cat([torch.tensor([0, w - win, 0, w - win]),
                        torch.randint(0, w - win + 1, (n - 4,), generator=g)]).to(torch.int32)
        av = torch.cat([torch.tensor([0, 0, h - win, h - win]),
                        torch.randint(0, h - win + 1, (n - 4,), generator=g)]).to(torch.int32)
        au, av = au.to(device), av.to(device)
        got = window_cuda.extract_windows_cuda(img, au, av, win)
        ref = window_cuda.extract_windows_plain(img, au, av, win)
        worst = max(worst, float((got - ref).abs().max()))
    # out-of-range anchors read 0 in both
    au_o = torch.tensor([-5, w - 10], dtype=torch.int32, device=device)
    av_o = torch.tensor([-3, h - 7], dtype=torch.int32, device=device)
    worst = max(worst, float((window_cuda.extract_windows_cuda(img, au_o, av_o, win)
                              - window_cuda.extract_windows_plain(img, au_o, av_o, win))
                             .abs().max()))
    assert worst <= 1e-6, f"extract_windows disagrees with its plain version: {worst}"
    ar = torch.arange(win, device=device)
    rows = av.long()[:, None] + ar
    cols = au.long()[:, None] + ar
    nbytes = 2 * n * win * win * 4 + 2 * n * 4
    b_ms, b_by = bound(nbytes, 0)
    results["extract_windows"] = dict(
        max_abs_err=worst, tol=1e-6, shape=f"N={n} win={win} image={h}x{w} (level 1)",
        ms=time_ms(lambda: window_cuda.extract_windows_cuda(img, au, av, win), device),
        plain_ms=time_ms(lambda: window_cuda.extract_windows_plain(img, au, av, win), device,
                         inner=2),
        library_ms=time_ms(lambda: img[rows[:, :, None], cols[:, None, :]], device),
        bound_ms=b_ms, bound_by=b_by)

    # K2: per-row levels, centres partly outside the image
    n_levels = 3
    worst = 0.0
    timing = None
    for s in (336, 168):
        level = torch.randint(0, n_levels, (s,), generator=g).to(torch.int32)
        dims = torch.tensor([list(cur_pyr[l].shape) for l in range(n_levels)])
        hw = dims[level.long()].float()
        cu = (torch.rand(s, generator=g) * (hw[:, 1] + 10.0) - 5.0)
        cv = (torch.rand(s, generator=g) * (hw[:, 0] + 10.0) - 5.0)
        au = torch.zeros(s, dtype=torch.int32)
        av = torch.zeros(s, dtype=torch.int32)
        for l in range(n_levels):
            a_u, a_v = clip_anchor(cu, cv, win, 0, *cur_pyr[l].shape)
            au = torch.where(level == l, a_u, au)
            av = torch.where(level == l, a_v, av)
        level, au, av = level.to(device), au.to(device), av.to(device)
        got = window_cuda.pack_level_windows_cuda(cur_pyr, level, au, av, win, n_levels)
        ref = window_cuda.pack_level_windows_plain(cur_pyr, level, au, av, win, n_levels)
        worst = max(worst, float((got - ref).abs().max()))
        if s == 336:
            timing = (level, au, av)
    assert worst <= 1e-6, f"pack_level_windows disagrees with its plain version: {worst}"
    level, au, av = timing
    s = 336
    h0, w0 = cur_pyr[0].shape
    stack = torch.zeros((n_levels, h0, w0), device=device)
    for l in range(n_levels):
        hl, wl = cur_pyr[l].shape
        stack[l, :hl, :wl] = cur_pyr[l]
    rows = av.long()[:, None] + ar
    cols = au.long()[:, None] + ar
    lv = level.long()[:, None, None]
    nbytes = 2 * s * win * win * 4 + 3 * s * 4
    b_ms, b_by = bound(nbytes, 0)
    results["pack_level_windows"] = dict(
        max_abs_err=worst, tol=1e-6, shape=f"S={s} (also 168) win={win} levels={n_levels}",
        ms=time_ms(lambda: window_cuda.pack_level_windows_cuda(
            cur_pyr, level, au, av, win, n_levels), device),
        plain_ms=time_ms(lambda: window_cuda.pack_level_windows_plain(
            cur_pyr, level, au, av, win, n_levels), device, inner=2),
        library_ms=time_ms(lambda: stack[lv, rows[:, :, None], cols[:, None, :]], device),
        bound_ms=b_ms, bound_by=b_by)


def check_coarse(calls, device, results):
    assert len(calls) == 4, f"expected 4 coarse levels on an IC frame, got {len(calls)}"
    worst = 0.0
    per_level = []
    for args, kw in calls:
        got = coarse_cuda.coarse_level_ic_cuda(*args, **kw)
        ref = coarse_cuda.coarse_level_ic_plain(*args, **kw)
        d_T = se3_dist(got[0], ref[0])
        d_a = abs(float(got[1]) - float(ref[1]))
        e_k, e_p = float(got[2]), float(ref[2])
        assert d_T < 1e-3 and d_a < 1e-3, f"coarse level disagrees: dT={d_T} da={d_a}"
        assert abs(e_k - e_p) <= 0.05 * abs(e_p) + 1e-6, f"coarse energy {e_k} vs {e_p}"
        assert int(got[3]) == int(ref[3]), f"coarse n_terms {int(got[3])} vs {int(ref[3])}"
        worst = max(worst, float((got[0] - ref[0]).abs().max()), d_a)
        per_level.append(dict(P=args[1].shape[1], iters=int(got[4]), plain_iters=int(ref[4])))
    # adversarial: nothing visible -> the state comes back unchanged
    args, kw = calls[-1]
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
    got = coarse_cuda.coarse_level_ic_cuda(*a3, **kw)
    ref = coarse_cuda.coarse_level_ic_plain(*a3, **kw)
    d_far = se3_dist(got[0], ref[0])
    assert d_far < 1e-3, f"coarse level (far-off init) disagrees: {d_far}"
    worst = max(worst, float((got[0] - ref[0]).abs().max()))

    # time the finest level (largest pattern)
    n, p = args[1].shape
    iters = int(coarse_cuda.coarse_level_ic_cuda(*args, **kw)[4])
    evals = iters + 1
    nbytes = n * 576 * 4 + n * p * 4 + n * p * 24 + n * 12 + n * 8 + n + 12 * 4 + 12 + 64
    flops = evals * (n * p * 100 + n * 30)
    b_ms, b_by = bound(nbytes, flops)
    results["coarse_level_ic"] = dict(
        max_abs_err=worst, tol=1e-3, shape=f"N={n} P={p} (level 1), {iters} iterations",
        levels=per_level,
        ms=time_ms(lambda: coarse_cuda.coarse_level_ic_cuda(*args, **kw), device),
        plain_ms=time_ms(lambda: coarse_cuda.coarse_level_ic_plain(*args, **kw), device,
                         inner=2),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)


def check_align(calls, device, results):
    assert len(calls) == 2, f"expected 2 alignment passes, got {len(calls)}"
    worst = 0.0
    n_conv = []
    for args, kw in calls:
        got = align_cuda.align_match_cuda(*args, **kw)
        ref = align_cuda.align_match_plain(*args, **kw)
        conv = ref[2] > 0.5
        assert bool(((got[2] > 0.5) == conv).all()), "align: converged flags differ"
        d_px = float((got[:2] - ref[:2]).abs().max())
        assert d_px <= 5e-3, f"align px differ by {d_px}"
        m = conv
        if bool(m.any()):
            assert float((got[3] - ref[3])[m].abs().max()) <= 1e-3, "align ncc"
            assert float((got[4:6] - ref[4:6])[:, m].abs().max()) <= 2e-2, "align gradient"
            rel = ((got[6] - ref[6]).abs() / (ref[6].abs() + 1.0))[m]
            assert float(rel.max()) <= 1e-2, "align chi2"
        worst = max(worst, d_px)
        n_conv.append(int(conv.sum()))
        # adversarial: an empty mask returns px_init and converges nowhere
        a2 = list(args)
        a2[4] = torch.zeros_like(args[4])
        dead = align_cuda.align_match_cuda(*a2, **kw)
        assert not bool((dead[2] > 0.5).any())
        assert float((dead[:2].T - args[3]).abs().max()) <= 1e-6
    args, kw = calls[0]
    s = args[5].shape[0]
    win, n_iter = kw["win"], kw["n_iter"]
    nbytes = s * (win * win + 100) * 4 + s * 16 + s * 16 + 2 * s + 8 * s * 4
    flops = s * ((n_iter + 1) * 64 * 32 + 64 * 40)
    b_ms, b_by = bound(nbytes, flops)
    results["align_match"] = dict(
        max_abs_err=worst, tol=5e-3, shape=f"S={s} (also {calls[1][0][5].shape[0]}) win={win} "
        f"n_iter={n_iter}", converged=n_conv,
        ms=time_ms(lambda: align_cuda.align_match_cuda(*args, **kw), device),
        plain_ms=time_ms(lambda: align_cuda.align_match_plain(*args, **kw), device,
                         inner=2),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)


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
    results["pose_lm"] = dict(
        max_abs_err=worst, tol=5e-4, shape=f"N={n}, {trials} trials (plain: {int(ref[3])})",
        ms=time_ms(lambda: pose_cuda.pose_lm_cuda(*args, **kw), device),
        plain_ms=time_ms(lambda: pose_cuda.pose_lm_plain(*args, **kw), device,
                         inner=2),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)


# ------------------------------------------------------------------ track phase
def initial_state(cam, cfg, device):
    (snap, prev_pyr, grad_mean, intensity, exposure, T_prev, prev_obs,
     frame_count) = track_state_from_checkpoint(BOOT_NPZ, cam, cfg, device)
    p = snap["pos_w"].shape[0]
    state = dict(snap=snap, prev_pyr=prev_pyr, prev_grad_mean=grad_mean,
                 prev_intensity=intensity, exposure_prev=exposure, T_prev=T_prev,
                 prev_obs=prev_obs, acc=torch.zeros((2, p), dtype=torch.int32, device=device),
                 T_rel=torch.as_tensor(se3np.identity().astype(np.float32), device=device))
    return state, frame_count


def run_one(step, state, img):
    return step(img, state["prev_pyr"], state["prev_grad_mean"], state["T_prev"],
                state["prev_obs"], state["prev_intensity"], state["exposure_prev"],
                state["T_rel"], state["snap"], state["acc"])


def advance(state, out):
    """Feed a step's result forward (map frozen: ``snap`` stays)."""
    nxt = dict(state)
    nxt.update(prev_pyr=out["data"]["pyr"], prev_grad_mean=out["data"]["grad_mean"],
               prev_intensity=out["data"]["intensity_mean"], exposure_prev=out["exposure"],
               T_prev=out["T_new"], prev_obs=out["obs_next"], acc=out["acc"])
    return nxt


def run_track(step, state, frames, device):
    """Track the frames; returns (per-frame records, ms per frame)."""
    recs, ms = [], []
    for img in frames:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = run_one(step, state, img)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        recs.append(dict(T_new=out["T_new"].cpu().numpy(), packed=out["packed"].cpu().numpy(),
                         acc=out["acc"].cpu().numpy(), px=out["px"].cpu().numpy(),
                         n_inliers=int(out["n_inliers"]), n_matches=int(out["n_matches"]),
                         used_fc=bool(out["used_fc"])))
        state = advance(state, out)
    return recs, ms


def track_ate(recs, gt_poses) -> float:
    est = np.stack([se3np.translation(se3np.inv(se3np.normalize(r["T_new"].astype(np.float64))))
                    for r in recs])
    gt = np.stack([se3np.translation(se3np.inv(T)) for T in gt_poses])
    return ate(est, gt, with_scale=True).rmse


def main() -> int:
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
    _cuda_build.lib()
    emit("build", seconds=round(time.perf_counter() - t0, 2),
         library=os.path.relpath(_cuda_build.build(), ROOT))

    cam, cfg = bench_camera(), Config()
    step, grid, n_obs_pad = build_step(cam, cfg, device)
    state0, frame_count = initial_state(cam, cfg, device)
    poses = trajectory(frame_count + N_FRAMES)
    gt = poses[frame_count:frame_count + N_FRAMES]
    scene = bench_scene(cam)
    frames = [scene.render(T) for T in gt]

    # ---- kernels: each against its plain version at the main path's shapes
    results = {}
    rec3, rec4, rec5, out0 = capture_kernel_inputs(step, state0, frames[0])
    assert not out0["used_fc"], "frame 0 took the FC branch: no K3 inputs to check"
    check_windows(out0["data"]["pyr"], device, results)
    check_coarse(rec3, device, results)
    check_align(rec4, device, results)
    check_pose(rec5, device, results)
    torch.cuda.synchronize(device)
    for name, r in results.items():
        emit("kernels", name=name, card=smi, **r)

    # ---- track: the main path, counters set to 0 just before, read just after
    zero_counters()
    recs, ms = run_track(step, state0, frames, device)
    launches = read_counters()
    n_ic = sum(not r["used_fc"] for r in recs)
    for name, n in launches.items():
        assert n > 0, f"kernel {name} was never launched on the main path"
    assert all(np.isfinite(r["T_new"]).all() and r["T_new"].shape == (3, 4) for r in recs)
    min_inl = min(r["n_inliers"] for r in recs)
    assert min_inl >= 50, f"a frame kept only {min_inl} inliers"
    rmse = track_ate(recs, gt)
    assert rmse < 0.10, f"ATE RMSE {rmse:.4f} m exceeds the 0.10 m gate"

    # second run: bitwise equal
    recs2, _ = run_track(step, state0, frames, device)
    for a, b in zip(recs, recs2):
        for k in ("T_new", "packed", "acc", "px"):
            assert np.array_equal(a[k], b[k], equal_nan=True), f"second run differs in {k}"

    # frame 1 with the plain versions on the card
    with plain_kernels():
        before = read_counters()
        ref1 = run_one(step, state0, frames[0])
        assert read_counters() == before, "the plain run launched a kernel"
    d_plain = se3_dist(torch.as_tensor(recs[0]["T_new"]), ref1["T_new"])
    assert d_plain < 1e-3, f"frame 1: kernels and plain versions differ by {d_plain}"

    emit("track", card=smi, frames=N_FRAMES, first_frame=frame_count, grid=list(grid),
         n_obs_pad=n_obs_pad, points=int(state0["snap"]["pos_w"].shape[0]),
         ms_per_frame_median=statistics.median(ms), ms_per_frame_first=ms[0],
         ic_frames=n_ic, fc_frames=N_FRAMES - n_ic, launches=launches,
         launches_per_frame={k: v / N_FRAMES for k, v in launches.items()},
         min_inliers=min_inl, min_matches=min(r["n_matches"] for r in recs),
         ate_rmse_m=rmse, frame1_vs_plain=d_plain, second_run_bitwise_equal=True)

    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=KERNEL_META[name][0],
             replaces=KERNEL_META[name][1], launches=launches[name],
             max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
             bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"])
        for name, r in results.items()]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

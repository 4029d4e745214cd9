"""The depth-filter sweep bisected: what each stage of ``update_seeds`` costs.

The port's counterpart of the JAX package's ``scripts/profile_update_seeds.py``.
The sweep is cut into chained prefixes of its own stages
(:data:`hso_tpu_torch.mapping.depth_filter.SWEEP_STAGES`, the functions
``update_seeds`` itself runs, in its order): ``0 geometry+warpmat``,
``1 +warp_ref_border``, ``2 +pack_windows`` (K2), ``3 +zmncc_search`` (K6),
``4 (removed)`` (the JAX script's separate 1-D pre-pass, gone there too: the
prefix of row 3 again), ``5 +align_mixed+ncc`` (K4), ``6 +grad+triang``, and
last ``update_seeds`` whole.  Each prefix folds every tensor its last stage
made into one scalar ``val`` and feeds it back into the carry,
``mu ← mu + val·1e-20``, so every frame depends on the one before.

Inputs are the JAX script's: ``s`` seeds (1,536), ``n`` frames (32),
``PinholeCamera(640, 480, 400, 400, 320, 240)``, numpy ``default_rng(0)``
drawn in its order (:func:`sweep_inputs`); every seed hosted by one keyframe
at the identity, exposure 1.

    python -m hso_tpu_torch.tools.profile_update_seeds [s=1536] [n=32] [reps=3]
        [cpu=1] [out=FILE]

Prints the JAX script's line per row (``name: ms/frame (marginal ±x)``), then
one JSON line per row, on the card with:

* ``device_ms_per_frame``: a CUDA graph of the prefix over one frame (the
  frame picked inside the graph), replayed over the ``n`` frames between CUDA
  events, the median of ``reps``; ``graph_floor_ms_per_frame`` in the header
  is the same graph with no stage (frame pick and carry only);
* ``eager_ms_per_frame``: host clock around the ``n`` frames run eagerly, the
  synchronisation at the end, the median of ``reps``, the rows in turns within
  each repetition: what the step pays today;
* ``device_kernels_per_frame``, ``device_busy_ms_per_frame`` and the device ms
  of K2, K4 and K6, from ``torch.profiler`` over one eager frame (the
  session with the most device events of ``PROFILED_FRAMES``); the
  wrappers' launches of K2, K4 and K6 in that frame; in the header each of
  those kernels' bound at ``s`` rows (:func:`kernel_bounds_ms`);
* each figure's marginal against the row before.

A capture that fails raises; nothing falls back to eager.  ``cpu=1`` runs the
same rows on the CPU (the kernels' plain versions; host ms only, the device
figures "not measured").  Without a GPU it exits 2 unless ``cpu=1`` is given.
"""

from __future__ import annotations

import json
import math
import statistics
import sys
import time

import numpy as np
import torch

from hso_tpu_torch.cameras import PinholeCamera
from hso_tpu_torch.mapping import depth_filter
from hso_tpu_torch.math import se3np
from hso_tpu_torch.ops.epipolar import EW

S_DEFAULT = 1536
N_DEFAULT = 32
REPS_DEFAULT = 3
H, W = 480, 640
#: the JAX script's rows: (label, number of SWEEP_STAGES the prefix runs);
#: None runs ``update_seeds`` whole
ROWS = (("0 geometry+warpmat", 1), ("1 +warp_ref_border", 2), ("2 +pack_windows", 3),
        ("3 +zmncc_search", 4), ("4 (removed)", 4), ("5 +align_mixed+ncc", 5),
        ("6 +grad+triang", 6), ("update_seeds", None))
OWN_KERNELS = {"pack_level_windows": "pack_level_windows_kernel",
               "align_match": "align_match_kernel", "zmncc_line_scores": "zmncc_line_kernel"}
#: published peaks of one H100 SXM: HBM bytes/s, float32 FLOP/s outside the
#: tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
#: the sigma² every seed starts from
SIGMA2 = 0.01


def camera() -> PinholeCamera:
    return PinholeCamera(W, H, 400.0, 400.0, 320.0, 240.0)


def px_error_angle(cam) -> float:
    """The bearing angle of a one-pixel error, as the handler derives it."""
    return float(math.atan(1.0 / (2.0 * cam.focal_mean)) * 2.0)


def sweep_inputs(s: int = S_DEFAULT, n: int = N_DEFAULT, seed: int = 0) -> dict:
    """The JAX script's inputs as numpy arrays, drawn in its order: pyramid
    levels 1 and 2, pixels, bearings, levels, species, gradient directions,
    inverse depths, host windows (anchors at 0), the current pose and ``n``
    frames of noise."""
    rng = np.random.default_rng(seed)
    pyr12 = tuple((rng.standard_normal((H >> lv, W >> lv)) * 40 + 120).astype(np.float32)
                  for lv in (1, 2))
    px = np.c_[rng.uniform(40, 600, s), rng.uniform(40, 440, s)].astype(np.float32)
    f = camera().cam2world(torch.as_tensor(px)).numpy().astype(np.float32)
    level = rng.integers(0, 3, s).astype(np.int32)
    species = rng.integers(0, 2, s).astype(np.int32)
    g = rng.standard_normal((s, 2))
    g /= np.linalg.norm(g, axis=-1, keepdims=True)
    mu0 = (1.0 / rng.uniform(2, 8, s)).astype(np.float32)
    host_win = (rng.standard_normal((s, depth_filter.HOST_WIN, depth_filter.HOST_WIN)) * 40
                + 120).astype(np.float32)
    T_cur = se3np.exp(np.array([0.05, 0.02, 0.01, 0.005, 0.003, 0.001])).astype(np.float32)
    imgs = (rng.standard_normal((n, H, W)) * 40 + 120).astype(np.float32)
    return dict(pyr12=pyr12, px=px, f=f, level=level, species=species,
                grad=g.astype(np.float32), mu0=mu0, host_win=host_win,
                host_anchor=np.zeros((s, 2), np.int32), T_cur=T_cur, imgs=imgs)


def seed_table(inp: dict, device) -> dict:
    """The seed table of :func:`sweep_inputs`: every slot live, hosted by ring
    slot 0, ``sigma2`` = ``SIGMA2``."""
    s = inp["px"].shape[0]
    seeds = depth_filter.empty_seeds(s, device)

    def t(a):
        return torch.as_tensor(a, device=device)

    seeds.update(valid=torch.ones((s,), dtype=torch.bool, device=device), px=t(inp["px"]),
                 f=t(inp["f"]), level=t(inp["level"]), species=t(inp["species"]),
                 grad=t(inp["grad"]), mu=t(inp["mu0"]),
                 sigma2=torch.full((s,), SIGMA2, dtype=torch.float32, device=device),
                 a=torch.full((s,), 10.0, device=device), b=torch.full((s,), 10.0, device=device),
                 z_range=torch.full((s,), 0.5, device=device),
                 converge_thresh=torch.full((s,), 200.0, device=device),
                 host_win=t(inp["host_win"]), host_anchor=t(inp["host_anchor"]))
    return seeds


class Sweep:
    """The inputs on one device and the rows' functions of (mu, frame)."""

    def __init__(self, inp: dict, device):
        self.device = device
        self.cam = camera()
        self.seeds = seed_table(inp, device)
        self.pyr12 = tuple(torch.as_tensor(p, device=device) for p in inp["pyr12"])
        self.imgs = torch.as_tensor(inp["imgs"], device=device)
        self.ring_T = torch.as_tensor(se3np.identity()[None].astype(np.float32), device=device)
        self.ring_exp = torch.ones((1,), dtype=torch.float32, device=device)
        self.T_cur = torch.as_tensor(inp["T_cur"], device=device)
        # device scalars: a capture may not copy from the host
        self.exposure = torch.ones((), dtype=torch.float32, device=device)
        self.px_err = torch.full((), px_error_angle(self.cam), dtype=torch.float32,
                                 device=device)

    def context(self, mu, img0):
        return depth_filter.sweep_context(dict(self.seeds, mu=mu), self.ring_T, self.ring_exp,
                                          (img0,) + self.pyr12, self.T_cur, self.exposure,
                                          self.cam)

    def prefix(self, mu, img0, n_stages: int) -> dict:
        """The first ``n_stages`` stages; returns what the last one added."""
        c = self.context(mu, img0)
        last = {}
        for _, stage in depth_filter.SWEEP_STAGES[:n_stages]:
            last = stage(c)
            c.update(last)
        return last

    def whole(self, mu, img0) -> dict:
        out, stats = depth_filter.update_seeds(
            dict(self.seeds, mu=mu), self.ring_T, self.ring_exp, (img0,) + self.pyr12, None,
            None, self.T_cur, self.exposure, self.px_err, self.cam)
        return dict(stats, seeds=out)

    def stage6_check(self) -> dict:
        """:func:`stage6_vs_update_seeds` on the first frame and the seeds' own
        ``mu``."""
        return stage6_vs_update_seeds(self.seeds, self.ring_T, self.ring_exp,
                                      (self.imgs[0],) + self.pyr12, self.T_cur, self.exposure,
                                      self.px_err, self.cam)

    def row_fn(self, n_stages):
        """``fn(mu, img0) -> val``: a row folded to one scalar."""
        if n_stages is None:
            return lambda mu, img0: fold(self.whole(mu, img0))
        return lambda mu, img0: fold(self.prefix(mu, img0, n_stages))


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)


def fold(outputs) -> torch.Tensor:
    """Every tensor of ``outputs`` summed into one finite float32 scalar."""
    sums = [torch.sum(t, dtype=torch.float32) for t in _tensors(outputs)]
    return torch.nan_to_num(torch.sum(torch.stack(sums)), nan=0.0, posinf=0.0, neginf=0.0)


def run_eager(fn, sw: Sweep, n: int) -> None:
    """``n`` frames of the chained row, eagerly."""
    mu = sw.seeds["mu"]
    for i in range(n):
        mu = mu + fn(mu, sw.imgs[i]) * 1e-20


def graph_ms_per_frame(fn, sw: Sweep, n: int, reps: int) -> list:
    """ms a frame of ``fn`` captured in one CUDA graph (the frame picked inside
    it by a device index) and replayed ``n`` times between CUDA events, for
    each of ``reps`` repetitions."""
    dev = sw.device
    mu = sw.seeds["mu"].clone()
    idx = torch.zeros((1,), dtype=torch.int64, device=dev)

    def body():
        img0 = sw.imgs.index_select(0, idx)[0]
        mu.add_(fn(mu, img0) * 1e-20)
        idx.add_(1).remainder_(n)

    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(3):
            body()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    out = []
    for _ in range(reps):
        mu.copy_(sw.seeds["mu"])
        idx.zero_()
        graph.replay()                     # warm
        torch.cuda.synchronize(dev)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            graph.replay()
        b.record()
        torch.cuda.synchronize(dev)
        out.append(a.elapsed_time(b) / n)
    return out


def counters() -> dict:
    from hso_tpu_torch.ops import align_cuda, epipolar_cuda, window_cuda

    return {"pack_level_windows": window_cuda.LAUNCHES, "align_match": align_cuda.LAUNCHES,
            "zmncc_line_scores": epipolar_cuda.LAUNCHES}


def kernel_bounds_ms(s: int) -> dict:
    """The least time an H100 could take for each kernel call of one sweep of
    ``s`` rows: the larger of its bytes over the memory rate and its float32
    operations over the peak, counted as ``chip_smoke.py``'s kernel lines
    count them (K2: windows written and read; K4 and K6 over all rows, K4 all
    10 iterations, K6 the dense score map of 40 steps)."""
    ew, n_steps, n_iter = EW, 40, 10
    ow = ew - 7

    def bound(nbytes, flops):
        return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS) * 1e3

    return {"pack_level_windows": bound(2 * s * ew * ew * 4 + 3 * s * 4, 0),
            "align_match": bound(s * (ew * ew + 100) * 4 + s * 34 + 8 * s * 4,
                                 s * ((n_iter + 1) * 64 * 32 + 64 * 40)),
            "zmncc_line_scores": bound(s * (ew * ew + 64) * 4 + s * 12 * 4,
                                       s * (ew * ow * 22 + ow * ow * (14 + 127 + 8)
                                            + n_steps * 30))}


def device_activity(prof) -> list:
    """(name, device µs) of every device event of a finished ``torch.profiler``
    run, read from its raw results: parsing them into function events
    takes seconds for the step's thousands of kernels a frame."""
    from torch._C._autograd import DeviceType

    return [(e.name(), e.duration_ns() / 1e3) for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


PROFILED_FRAMES = 3


def profile_frame(fn, sw: Sweep) -> dict:
    """One eager frame under ``torch.profiler``, ``PROFILED_FRAMES`` times, a
    session each: device kernels, busy ms and the own kernels' device ms of
    the session that saw the most device events; and the wrappers' launches
    in one frame.  The frame's inputs are the same each time, so it launches
    the same kernels; a session now and then loses one record (522 of 523 on
    the H100 once), hence the most of a few, each count kept under
    ``device_kernels_per_frame_samples``."""
    from torch.profiler import ProfilerActivity, profile

    cs = counters()
    mu = sw.seeds["mu"]
    samples = []
    for _ in range(PROFILED_FRAMES):
        before = {k: d[k] for k, d in cs.items()}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn(mu, sw.imgs[0])
            torch.cuda.synchronize(sw.device)
        samples.append((device_activity(prof), {k: d[k] - before[k] for k, d in cs.items()}))
    events, launches = max(samples, key=lambda s: len(s[0]))
    if not events:
        return {"device_kernels_per_frame": "not measured: the profiler reported no device "
                "time", "launches_per_frame": launches}
    own = {k: sum(us for n, us in events if name in n) / 1e3 for k, name in OWN_KERNELS.items()}
    return {"device_kernels_per_frame": len(events),
            "device_kernels_per_frame_samples": [len(e) for e, _ in samples],
            "device_busy_ms_per_frame": sum(us for _, us in events) / 1e3,
            "own_kernel_device_ms": own, "launches_per_frame": launches}


def stage6_vs_update_seeds(seeds, ring_T, ring_exp, cur_pyr, T_cur, exposure, px_err,
                           cam) -> dict:
    """Stage 6 of the prefix chain and ``update_seeds`` on the same inputs: the
    matched pixels, and the depths ``update_seeds`` triangulated (recorded at
    its call of ``triangulate_depth``, masked as stage 6 masks them), compared
    bit for bit; the tensors themselves under ``tensors``."""
    seen = []
    real = depth_filter.triangulate_depth

    def recording(*a, **k):
        seen.append(real(*a, **k))
        return seen[-1]

    c = depth_filter.sweep_context(seeds, ring_T, ring_exp, cur_pyr, T_cur, exposure, cam)
    for _, stage in depth_filter.SWEEP_STAGES:
        c.update(stage(c))
    depth_filter.triangulate_depth = recording
    try:
        _, stats = depth_filter.update_seeds(seeds, ring_T, ring_exp, cur_pyr, None, None,
                                             T_cur, exposure, px_err, cam)
    finally:
        depth_filter.triangulate_depth = real
    assert len(seen) == 1, f"update_seeds triangulated {len(seen)} times"
    z_whole = torch.where(c["meas_ok"], seen[0][0], torch.zeros_like(seen[0][0]))
    return {"px_bitwise": bool(torch.equal(c["px_match0"], stats["px_match"])),
            "z_meas_bitwise": bool(torch.equal(c["z_meas"], z_whole)),
            "matched_within_meas_ok": bool(torch.all(c["meas_ok"] | ~stats["matched"])),
            "n_matched": int(stats["matched"].sum()),
            "tensors": {"px": c["px_match0"], "z_meas": c["z_meas"],
                        "px_match": stats["px_match"], "z_whole": z_whole}}


def profile(s: int = S_DEFAULT, n: int = N_DEFAULT, reps: int = REPS_DEFAULT,
            device="cuda") -> dict:
    """Every row at ``s`` seeds over ``n`` frames; returns the header and the
    rows (see the module's docstring)."""
    device = torch.device(device)
    sw = Sweep(sweep_inputs(s, n), device)
    fns = [(label, sw.row_fn(k)) for label, k in ROWS]
    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)

    for _, fn in fns:                          # warm: kernels built, allocator settled
        run_eager(fn, sw, 1)
    sync()
    eager = {label: [] for label, _ in fns}
    for _ in range(reps):                      # the rows in turns within each repetition
        for label, fn in fns:
            sync()
            t0 = time.perf_counter()
            run_eager(fn, sw, n)
            sync()
            eager[label].append((time.perf_counter() - t0) * 1e3 / n)

    head = {"s": s, "n": n, "reps": reps, "device": str(device),
            "kernel_bounds_ms": kernel_bounds_ms(s)}
    rows = []
    for label, fn in fns:
        row = {"row": label, "eager_ms_per_frame": statistics.median(eager[label]),
               "eager_ms_per_frame_all": eager[label]}
        if on_card:
            dev_ms = graph_ms_per_frame(fn, sw, n, reps)
            row.update(device_ms_per_frame=statistics.median(dev_ms),
                       device_ms_per_frame_all=dev_ms, **profile_frame(fn, sw))
        else:
            row.update(device_ms_per_frame="not measured (CPU run)",
                       device_kernels_per_frame="not measured (CPU run)")
        rows.append(row)
    if on_card:
        floor = graph_ms_per_frame(lambda mu, img0: fold([img0[:1, :1]]), sw, n, reps)
        head["graph_floor_ms_per_frame"] = statistics.median(floor)
    for prev, row in zip([None] + rows[:-1], rows):
        for key in ("eager_ms_per_frame", "device_ms_per_frame", "device_kernels_per_frame",
                    "device_busy_ms_per_frame"):
            if isinstance(row.get(key), (int, float)):
                before = prev[key] if prev is not None else 0.0
                row[key.replace("_per_frame", "_marginal")] = row[key] - before
    return {"head": head, "rows": rows}


def text_lines(doc: dict) -> list:
    """The JAX script's human-readable line per row."""
    out = []
    key = ("device_ms_per_frame" if isinstance(doc["rows"][0]["device_ms_per_frame"], float)
           else "eager_ms_per_frame")
    prev = 0.0
    for row in doc["rows"]:
        ms = row[key]
        out.append(f"{row['row']:>22s}: {ms:7.3f} ms/frame  (marginal {ms - prev:+7.3f})")
        prev = ms
    return out


def main(argv=None) -> int:
    from hso_tpu_torch.tools.make_hard_artifact import device_of, hardware

    args = dict(a.split("=", 1) for a in (sys.argv[1:] if argv is None else argv) if "=" in a)
    device = device_of(args, "profile_update_seeds")
    if device is None:
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    doc = profile(int(args.get("s", S_DEFAULT)), int(args.get("n", N_DEFAULT)),
                  int(args.get("reps", REPS_DEFAULT)), device)
    doc["head"].update(hardware(device))
    if device.type == "cuda":
        check = Sweep(sweep_inputs(doc["head"]["s"], 1), device).stage6_check()
        check.pop("tensors")
        doc["head"]["stage6_vs_update_seeds"] = check
    for line in text_lines(doc):
        print(line)
    print(json.dumps(doc["head"]))
    for row in doc["rows"]:
        print(json.dumps(row))
    if args.get("out"):
        with open(args["out"], "w") as fh:
            json.dump(doc, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

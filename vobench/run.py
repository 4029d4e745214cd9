"""One run of one cell of the benchmark of ``hso_tpu_torch``, the frame handler
fed by a camera stream.

    python3 vobench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``) names a configuration, read from
``vobench/configs/<config>.json`` (the camera, the scene, the handler), and a
traffic mix, read from ``vobench/traffic/<traffic>.json`` (the feed, the
motion, the warm-up); the cell's own file ``vobench/limits/<cell>.json``
holds the limits of the comparison that decides ``correct`` and, for a closed
loop, how many frames a second of the window are rendered (about twice what
the program takes); each per-layer metric is read by
``vobench/metrics/<metric>.py``.

What a configuration, a limits file and the files beside them may state:

* the camera as the dataset publishes it (``calibration``: ``Pinhole`` with
  radial-tangential distortion, or ``FOV``), written as the program's
  calibration file, which the program rescales above ``MAX_RESOLUTION``; the
  frames are rendered at that size through the same model;
* the handler's settings, ``photometric_calib`` among them;
* the camera's photometric chain (``photometric``: exposure, vignette,
  response; ``vobench.scene.Photometry``);
* a compared number that is none of ``BUILTIN_NUMBERS``: read by
  ``vobench/checks/<name>.py``'s ``read(ctx)`` once the window has closed,
  from the handler, the configuration, the rendered poses, the statuses and
  the photometric truth;
* further controls (``controls``: name → the handler's settings), which
  ``--control`` takes beside the built-in ones.

Set-up: the box's textures and the start phase along the sweep are drawn from
``--seed``; every frame the run feeds is rendered on the device and handed to
the handler as a host uint8 array; ``run_dataset.make_handler`` builds the
handler, which takes the warm frames from frame 0 (bootstrap, keyframe events,
the captures of its device programs).  Then the window: ``--seconds`` of the
mix's feed, closed loop (the lag-1 ``add_image_pipelined`` then ``flush``) or
open loop (``add_image`` at the camera's rate, each frame timed from when it
was due), ending in a device synchronise; the feed's thread runs pinned to the
CPU that is quickest at its start.  After it the handler's answers are judged
against the scene, and a sample of the window's windowed-BA solves against a
plain solve of the same problems (``vobench/reference``).

``--trace 1`` runs the window with the handler's stage timers on, then a short
plain segment on the host clock, then ``torch.profiler`` sessions, the last
thing the process does; it prints the per-layer metrics instead of the
end-to-end ones.

Prints one JSON object as the last line of standard output; the compared
numbers, each beside its limit, end standard error.  Exits 2 without a CUDA
device (``--device cpu`` rehearses the run on the CPU: its numbers are no
measurement), 3 when a module of JAX or of the JAX package is loaded.
"""

from __future__ import annotations

import os
import sys
import time

T_IMPORT = time.time()
# one process with few threads: the handler's host work is small arrays, and
# thread pools on a shared host only add jitter
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import hashlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
from collections import deque  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "hso_tpu")
SPIN_S = 0.002     #: an open loop's wait before a due frame: slept, then spun for this long
CACHE_DIR = os.path.join(ROOT, ".vobench_cache")
BA_SOLVES_JUDGED = 4   #: windowed-BA solves of the window the reference solves again
#: the comparison's controls, each a guarantee of the configurations broken:
#: the matcher's subpixel alignment cut to no iteration (tracking is lost),
#: and the windowed BA cut to no iteration (tracking goes on)
CONTROLS = {"align_cut": ("align_max_iter", 0), "ba_cut": ("loba_num_iter", 0)}
#: the compared numbers the harness reads itself; any other is a file of ``vobench/checks``
BUILTIN_NUMBERS = frozenset({
    "lost_frames", "ate_rmse_mm", "pos_err_max_mm", "rot_err_max_deg", "scale", "point_n",
    "point_depth_err_p50", "seed_n", "seed_depth_err_p50", "seed_z_p50", "ba_cost_gap_max"})
#: handler settings that only its construction applies (``run_dataset.make_handler``)
AT_CONSTRUCTION = ("photometric_calib",)


def process_start() -> float:
    """The epoch second this process started (``/proc``, 10 ms steps), or the
    import of this module where ``/proc`` has no answer."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = float(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return time.time() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def log(msg: str) -> None:
    print(f"[vobench {time.time() - T_IMPORT:7.2f}s] {msg}", file=sys.stderr, flush=True)


def loaded_forbidden() -> list[str]:
    """Modules of JAX or of the JAX package in this process, by top-level name
    compared whole (``hso_tpu_torch`` is not ``hso_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_json(*parts) -> dict:
    with open(os.path.join(ROOT, *parts)) as fh:
        return json.load(fh)


def load_reader(name: str, folder: str = "metrics"):
    """The ``read(ctx)`` of ``vobench/<folder>/<name>.py``."""
    path = os.path.join(ROOT, "vobench", folder, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"vobench_{folder}_{len(sys.modules)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def controls_of(limits: dict) -> dict:
    """Each control's handler settings: the built-in ones, then the cell's."""
    out = {name: dict([kv]) for name, kv in CONTROLS.items()}
    for name, settings in limits.get("controls", {}).items():
        if name in out or name == "none":
            raise ValueError(f"the control {name!r} is already defined")
        out[name] = dict(settings)
    return out


def calibration_text(cal: dict) -> str:
    """The program's calibration file of a configuration's ``calibration``, as
    the dataset gives it."""
    if cal["model"] == "Pinhole":
        vals = (cal["fx"], cal["fy"], cal["cx"], cal["cy"], *cal["distortion"])
        rectify = False
    elif cal["model"] == "FOV":
        vals, rectify = cal["params"], cal["rectify"]
    else:
        raise ValueError(f"no camera model {cal['model']!r}: Pinhole or FOV")
    return (" ".join([cal["model"]] + [repr(float(x)) for x in vals]) + "\n"
            + f"{cal['width']} {cal['height']}\n{'true' if rectify else 'false'}\n")


def cell_metrics(bench: dict, cell: str, traced: bool) -> list[dict]:
    """The metrics this cell reports: end-to-end untraced, per-layer traced."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not traced:
        return e2e
    moves = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell]) and m["moves"] in moves]


def percentile(x, q: float) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(x, np.float64), q))


def coarse_features(width: int, height: int, max_fts: int) -> int:
    """The cells of the handler's candidate grid, the coarse tracker's feature
    count (frozen from ``hso_tpu_torch/pipeline/scan.py::frame_grid``)."""
    cell = max(int(math.sqrt(width * height / max_fts) * 0.8), 16)
    return -(-height // cell) * -(-width // cell)


def finite(v):
    return v if v is not None and math.isfinite(v) else None


def pin_to_quickest_cpu() -> tuple[int, dict] | None:
    """Pins the calling thread, the one that runs the handler's host work, to
    the CPU of this process's set that runs a fixed stretch of Python in the
    least time now (best of three), as a deployment gives its tracking thread
    a quiet core.  The host's CPUs are shared, and their speeds differ by up
    to a half from one to another at a time.  Returns the CPU and each one's
    seconds."""
    try:
        cpus = sorted(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return None
    if len(cpus) < 2:
        return None
    best = {}
    for _ in range(3):
        for c in cpus:
            os.sched_setaffinity(0, {c})
            t0 = time.perf_counter()
            x = 0
            for i in range(100_000):
                x += i * i
            dt = time.perf_counter() - t0
            best[c] = min(best.get(c, dt), dt)
    quickest = min(best, key=best.get)
    os.sched_setaffinity(0, {quickest})
    return quickest, best


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi gave no answer"


class Feed:
    """The traffic mix's way of handing frames to the handler, with each
    frame's latency and the results in frame order."""

    def __init__(self, vo, frames, traffic: dict, rate_hz: float):
        self.vo, self.frames = vo, frames
        self.lag1 = traffic["feed"] == "lag1"
        self.open = traffic["loop"] == "open"
        self.rate = rate_hz
        self.next = 0              # the next frame index to feed
        self.results, self.lat_s = [], []
        self.late_s, self.backlog = [], 0

    def _submit(self, k: int, t_ref: float):
        vo, img = self.vo, self.frames[k]
        if not self.lag1:
            r = vo.add_image(img, ts=float(k))
            self.results.append(r)
            self.lat_s.append(time.perf_counter() - t_ref)
            return
        self._refs.append(t_ref)
        r = vo.add_image_pipelined(img, ts=float(k))
        if r is not None:
            t = time.perf_counter()
            self.results.append(r)
            self.lat_s.append(t - self._refs.popleft())

    def _drain(self):
        if self.lag1:
            rs = self.vo.flush()
            t = time.perf_counter()
            for r in rs:
                self.results.append(r)
                self.lat_s.append(t - self._refs.popleft())

    def run(self, seconds: float | None = None, n: int | None = None, paced: bool = True) -> int:
        """Feed for ``seconds`` (closed loop: while time is left; open loop:
        the frames due in them) or ``n`` frames, then drain the lag-1
        pipeline.  Returns the frames fed."""
        self._refs = deque()
        t0 = time.perf_counter()
        k0 = self.next
        if seconds is not None and self.open:
            n = int(math.ceil(seconds * self.rate))
        while True:
            j = self.next - k0
            if n is not None and j >= n:
                break
            if self.next >= len(self.frames):
                raise RuntimeError(f"the feed ran out of rendered frames at frame {self.next}")
            if self.open and paced:
                due = t0 + j / self.rate
                wait = due - time.perf_counter()
                if wait > SPIN_S:
                    time.sleep(wait - SPIN_S)
                while time.perf_counter() < due:     # the last stretch spun, not slept
                    pass
                t_sub = time.perf_counter()
                self.late_s.append(t_sub - due)
                self.backlog = max(self.backlog, int((t_sub - t0) * self.rate) - j)
                self._submit(self.next, due)
            else:
                if seconds is not None and n is None and time.perf_counter() - t0 >= seconds:
                    break
                self._submit(self.next, time.perf_counter())
            self.next += 1
        self._drain()
        return self.next - k0


def main(argv=None) -> int:
    t_proc = process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0, choices=(0, 1))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default); cpu rehearses the run and measures nothing")
    ap.add_argument("--control", default="none",
                    help="run the comparison's control (built-in: "
                         + ", ".join(CONTROLS) + "; or one of the cell's limits file) "
                         "instead of the program as the configuration states it")
    ap.add_argument("--warm-frames", type=int, default=None,
                    help="rehearsal only: fewer warm frames than the mix states")
    ap.add_argument("--max-fps", type=float, default=None,
                    help="rehearsal only: fewer frames rendered for a closed loop")
    args = ap.parse_args(argv)

    bench = load_json("BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"vobench: no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    conf = load_json("vobench", "configs", f"{cell['config']}.json")
    traffic = load_json("vobench", "traffic", f"{cell['traffic']}.json")
    limits = load_json("vobench", "limits", f"{cell['name']}.json")
    traced = bool(args.trace)
    controls = controls_of(limits)
    if args.control != "none" and args.control not in controls:
        print(f"vobench: no control {args.control!r}; the cell has {sorted(controls)}",
              file=sys.stderr)
        return 2
    control = controls.get(args.control, {})
    data_checks = {name: load_reader(name, "checks") for name in limits["compare"]
                   if name not in BUILTIN_NUMBERS}

    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE_DIR, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE_DIR, "torch_extensions"))
    import numpy as np
    import torch

    on_card = args.device == "cuda"
    if on_card and (not torch.cuda.is_available()
                    or torch.cuda.device_count() < int(cell["chips"])):
        print(f"vobench: the cell needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    device = torch.device(args.device)

    from hso_tpu_torch.io.calib import parse_calib
    from hso_tpu_torch.pipeline.frame_handler import RESULT_FAILURE, STAGE_DEFAULT
    from hso_tpu_torch.pipeline.scan import pin_float32_matmul
    from hso_tpu_torch.run_dataset import make_handler

    from vobench import ba_tap
    from vobench import scene as scene_mod
    from vobench import trace as trace_mod
    from vobench import trajectory
    from vobench.reference import ba as ba_ref
    from vobench.reference import check

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    pin_float32_matmul()

    tmp = tempfile.mkdtemp(prefix="vobench-")
    try:
        # ---- the camera (the program's, from the calibration as a user gives it)
        cal = conf["calibration"]
        calib_path = os.path.join(tmp, "camera.txt")
        calib_bytes = calibration_text(cal).encode()
        with open(calib_path, "wb") as fh:
            fh.write(calib_bytes)
        cam = parse_calib(calib_path)
        rcam = scene_mod.camera(cal)
        if (cam.width, cam.height) != (rcam.width, rcam.height):
            raise RuntimeError(f"the program's camera is {cam.width}x{cam.height}, the "
                               f"rendered frames {rcam.width}x{rcam.height}")
        rate = float(traffic["rate_hz"] if traffic.get("rate_hz") else conf["rate_hz"])

        # ---- the frames: warm-up, window, and the traced segments after it
        seed = args.seed % (1 << 63)
        phase_s = float(np.random.default_rng([seed, 1]).uniform(*traffic["phase_s"]))
        n_warm = traffic["warm_frames"] if args.warm_frames is None else args.warm_frames
        fps_cap = rate if traffic["loop"] == "open" else float(
            limits["render_frames_per_s"] if args.max_fps is None else args.max_fps)
        seg = args.seconds + (traffic["plain_seconds"] if traced else 0.0)
        n_frames = n_warm + int(math.ceil(seg * fps_cap)) + 2
        if traced:
            n_frames += traffic["profile_sessions"] * traffic["profile_frames"]
        motion = dict(traffic["motion"])
        motion["amplitude"] = [[max(0, n_warm + f), a] for f, a in
                               motion.get("amplitude_after_warm", [[0, 1.0]])]
        gt = trajectory.poses(n_frames, motion, phase_s, rate)
        t_render = time.perf_counter()
        photometry = None
        if "photometric" in conf:
            photometry = scene_mod.Photometry(conf["photometric"], rcam, n_frames, rate,
                                              np.random.default_rng([seed, 2]), device)
        scene = scene_mod.BoxScene(seed=seed, device=device, **conf["scene"])
        frames = scene.render_frames(rcam, gt, photometry=photometry)
        sync()
        log(f"{args.workload}: seed {args.seed}, phase {phase_s:.4f} s, {n_frames} frames "
            f"rendered ({rcam.width}x{rcam.height}) in {time.perf_counter() - t_render:.3f} s, "
            f"rate {rate} Hz")

        # ---- the handler, warmed from frame 0 through its mix's feed
        # a control's settings that only construction applies are built in; the
        # handler then has to run as the configuration states, with those
        built = dict(conf["handler"], **{k: v for k, v in control.items() if k in AT_CONSTRUCTION})
        vo, undistort = make_handler(cam, args.device, photo=built["photometric_calib"])
        if undistort is not None:
            raise RuntimeError("the configuration's camera asks for rectified frames")
        stated = {k: getattr(vo.cfg, k) for k in built}
        if stated != built:
            raise RuntimeError(f"the handler does not run as the configuration states: "
                               f"{stated} against {built}")
        for key, val in control.items():
            if key not in AT_CONSTRUCTION:
                if not hasattr(vo.cfg, key):
                    raise ValueError(f"the control {args.control!r} sets {key!r}, which the "
                                     f"handler has not")
                setattr(vo.cfg, key, val)
        feed = Feed(vo, frames, traffic, rate)
        feed.run(n=n_warm, paced=False)
        sync()
        statuses = [r.status for r in feed.results]
        tracking_at_window = vo.stage == STAGE_DEFAULT
        n_kf_warm = len(vo.kfs.frames)
        graphs_warm = (len(vo._ba_solves), len(vo._kf_graphs))
        log(f"warm: {n_warm} frames, {n_kf_warm} keyframes, stage {vo.stage}, "
            f"BA graphs {graphs_warm[0]}, map graphs {graphs_warm[1]}")
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
            pinned = pin_to_quickest_cpu()
            if pinned is not None:
                log(f"host: feed pinned to cpu {pinned[0]}; seconds of the probe by cpu "
                    + ", ".join(f"{c}: {t:.6f}" for c, t in sorted(pinned[1].items())))

        # ---- the window
        stage_csv = None
        if traced:
            vo.enable_tracing(trace_name="stages", trace_dir=tmp)
            stage_csv = vo.monitor.path
        feed.results, feed.lat_s = [], []
        tap = ba_tap.Tap(BA_SOLVES_JUDGED, seed, on_card)
        tap.install()
        sync()
        tap.on = True
        t_win0 = time.time()
        setup_s = t_win0 - t_proc
        w0 = time.perf_counter()
        n_win = feed.run(seconds=args.seconds)
        sync()
        window_s = time.perf_counter() - w0
        tap.on = False
        tap.remove()
        win_results, lat_s = feed.results, feed.lat_s
        memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        graphs_win = (len(vo._ba_solves), len(vo._kf_graphs))
        log(f"window: {n_win} frames in {window_s:.4f} s, setup {setup_s:.3f} s; captured "
            f"in the window: BA graphs {graphs_win[0] - graphs_warm[0]}, map graphs "
            f"{graphs_win[1] - graphs_warm[1]}; windowed-BA solves {tap.count}, "
            f"{len(tap.kept)} kept for the reference")
        if feed.open:
            log(f"generator: late p50 {1e3 * percentile(feed.late_s, 50):.4f} ms, "
                f"max {1e3 * max(feed.late_s):.4f} ms, largest backlog {feed.backlog} frames")

        ctx = None
        if traced:
            vo.monitor.close()
            vo.monitor = None
            feed.results, feed.lat_s = [], []
            sync()
            p0 = time.perf_counter()
            n_plain = feed.run(seconds=traffic["plain_seconds"])
            sync()
            plain_s = time.perf_counter() - p0
            prof = trace_mod.profile(lambda: feed.run(n=traffic["profile_frames"]),
                                     traffic["profile_sessions"], tmp, sync, on_card)
            seg_results = feed.results
            ctx = dict(stages=trace_mod.read_stage_csv(stage_csv),
                       plain=dict(frames=n_plain, seconds=plain_s), profile=prof,
                       n_features=coarse_features(rcam.width, rcam.height,
                                                  conf["handler"]["max_fts"]))
            win_results = win_results + seg_results

        # ---- failures: a failed frame, and every frame after tracking was lost
        statuses += [r.status for r in win_results]
        bad = [i for i, s in enumerate(statuses) if s == RESULT_FAILURE and i >= n_warm]
        first_bad = min(bad) if bad else len(statuses)
        if not tracking_at_window:
            first_bad = n_warm
        elif vo.stage != STAGE_DEFAULT:
            first_bad = min(first_bad, len(statuses) - 1)
        failed = len(statuses) - first_bad
        attempted = n_win

        # ---- the comparison with the scene, once the window has closed
        forbidden = loaded_forbidden()
        est = np.full((len(statuses), 3, 4), np.nan)
        for ts, T in vo.trajectory:
            if int(ts) < len(statuses):
                est[int(ts)] = T
        tracked = np.array([s in ("keyframe", "frame") for s in statuses]) \
            & np.isfinite(est).all(axis=(1, 2))
        timed = np.zeros(len(statuses), bool)
        timed[n_warm:] = True
        timed &= tracked
        pts = vo.points
        kf_frame = np.array([f.frame_id for f in vo.kfs.frames], np.int64)
        live = np.nonzero(pts.valid)[0]
        points = dict(frame=kf_frame[pts.host_kf[live]], f=pts.host_f[live].astype(np.float64),
                      idist=pts.idist[live].astype(np.float64))
        sd = {k: vo.seeds[k].cpu().numpy() for k in ("valid", "host", "f", "mu", "sigma2",
                                                      "n_updates")}
        ring = np.asarray(vo.seed_ring)
        host_kf = np.where(sd["valid"], ring[np.clip(sd["host"], 0, len(ring) - 1)], -1)
        keep = sd["valid"] & (host_kf >= 0) & (sd["n_updates"] >= limits["seed_min_updates"])
        seeds = dict(frame=kf_frame[host_kf[keep]], f=sd["f"][keep].astype(np.float64),
                     idist=sd["mu"][keep].astype(np.float64),
                     sigma=np.sqrt(sd["sigma2"][keep].astype(np.float64)))
        check_ctx = dict(handler=vo, config=conf, limits=limits, gt=gt[:len(statuses)],
                         statuses=statuses, n_warm=n_warm, photometric=photometry)
        data_numbers = {name: read(check_ctx) for name, read in data_checks.items()}
        del vo, feed, check_ctx
        log(f"sha256: frames {hashlib.sha256(frames).hexdigest()} ({len(frames)} frames), "
            f"calibration {hashlib.sha256(calib_bytes).hexdigest()}")
        if on_card:
            torch.cuda.empty_cache()
        if tracked.sum() < 3 or not timed.any():
            numbers = {}
        else:
            numbers = check.judge(scene, gt[:len(statuses)], est, tracked, timed, points, seeds)
        numbers["lost_frames"] = failed
        gaps = []
        for i, item in enumerate(tap.kept):
            r = ba_ref.solve_gap(item["args"], item["kw"], item["out"])
            log(f"BA solve {i}: " + ", ".join(f"{k} {v}" for k, v in r.items()))
            if r["gap"] is not None:
                gaps.append(r["gap"])
        tap.kept.clear()
        if gaps:
            numbers["ba_cost_gap_max"] = max(gaps)
        numbers.update(data_numbers)

        checks, correct = {}, bool(numbers) and not forbidden
        for name, lim in limits["compare"].items():
            v = numbers.get(name)
            ok = v is not None and np.isfinite(v) and v <= lim
            correct &= bool(ok)
            checks[name] = {"value": finite(v), "limit": lim}
        for k, v in numbers.items():
            if k not in checks:
                log(f"also read: {k} = {v}")

        # ---- the metrics
        metrics = {}
        device_info = dict(platform="gpu" if on_card else "cpu",
                           kind=torch.cuda.get_device_name(device) if on_card else "cpu",
                           count=int(cell["chips"]) if on_card else 0,
                           memory_peak_bytes=int(memory_peak))
        result = dict(correct=correct, attempted=attempted, failed=failed)
        if not traced:
            lat_ms = [1e3 * x for x in lat_s]
            n_res = len(win_results)
            w_statuses = [r.status for r in win_results]
            # a frame that failed or lost tracking misses every limit
            miss = 1e3 * window_s
            lat_ms = [miss if (i + n_warm >= first_bad or s == RESULT_FAILURE) else x
                      for i, (x, s) in enumerate(zip(lat_ms, w_statuses))]
            values = dict(frames_per_s=n_res / window_s, frame_p50_ms=percentile(lat_ms, 50),
                          frame_p95_ms=percentile(lat_ms, 95), setup_s=setup_s)
            for m in cell_metrics(bench, cell["name"], False):
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
            log(f"{n_res} frames, {sum(s == 'keyframe' for s in w_statuses)} keyframe events "
                f"in the window; latency p50/p95/max {values['frame_p50_ms']:.4f} / "
                f"{values['frame_p95_ms']:.4f} / {max(lat_ms):.4f} ms")
        else:
            for m in cell_metrics(bench, cell["name"], True):
                v = load_reader(m["name"])(ctx)
                if finite(v) is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            prof = ctx["profile"]
            if prof is not None:
                device_info["busy_s"] = prof["busy_s"]
                device_info["window_s"] = prof["window_s"]
                result["breakdown"] = trace_mod.breakdown(prof)
        result["metrics"] = metrics
        result["device"] = device_info
        result["checks"] = checks
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    forbidden = loaded_forbidden()      # the data checks read after the first look
    if forbidden:
        print(f"vobench: modules of JAX or the JAX package loaded: {forbidden}", file=sys.stderr)
        return 3
    if on_card:
        log(f"card: {card_line()}")
    log(f"correct: {correct}")
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

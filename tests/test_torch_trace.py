"""Tracing: the port's ``PerformanceMonitor`` against the JAX package's
(``hso_tpu/utils/trace.py``) on the same calls (headers and logged values
equal as text; timer columns equal where they are set to a value, zero where
a stage did not run), the handler's columns against the JAX handler's (the
JAX logs kept, the stages the port never runs dropped), the monitor's spans,
device intervals and row figures on a made-up clock, and a resumed handler's
lag-1 loop traced without fences on the CPU, its events on a made-up clock."""

import csv
import os

import numpy as np
import pytest
import torch

from hso_tpu.cameras import PinholeCamera as JaxCamera
from hso_tpu.config import Config as JaxConfig
from hso_tpu.pipeline.frame_handler import FrameHandler as JaxHandler
from hso_tpu.utils.trace import PerformanceMonitor as JaxMonitor
from hso_tpu_torch.cameras import PinholeCamera
from hso_tpu_torch.config import Config
from hso_tpu_torch.pipeline.frame_handler import FrameHandler
from hso_tpu_torch.utils import trace
from hso_tpu_torch.utils.trace import PerformanceMonitor

torch.set_num_threads(1)


def drive(mon, seed=0):
    """The same calls on a monitor: timers and logs registered, three frames
    of set and logged values, one timed stage, one stage skipped."""
    rng = np.random.default_rng(seed)
    for t in ("a", "b", "tot_time"):
        mon.add_timer(t)
    for name in ("frame_id", "n_inliers", "is_keyframe", "err_px"):
        mon.add_log(name)
    mon.init()
    for k in range(3):
        mon.new_frame()
        if k != 1:
            with mon.timing("a"):
                pass
        mon.set_timer("tot_time", float(rng.uniform(0, 1)))
        mon.log("frame_id", k)
        mon.log("n_inliers", int(rng.integers(0, 400)))
        mon.log("is_keyframe", k == 2)
        mon.log("err_px", float(rng.normal()))
        mon.update_finished()
    mon.close()
    with open(mon.path if hasattr(mon, "path") else
              os.path.join(mon.trace_dir, f"{mon.trace_name}.csv")) as fh:
        return list(csv.reader(fh))


def test_monitor_csv_equal(tmp_path):
    rows_j = drive(JaxMonitor("t", str(tmp_path / "j")))
    rows_t = drive(PerformanceMonitor("t", str(tmp_path / "t")))
    assert rows_t[0] == rows_j[0]
    assert rows_t[0] == ["timer_a", "timer_b", "timer_tot_time", "log_frame_id",
                         "log_n_inliers", "log_is_keyframe", "log_err_px"]
    assert len(rows_t) == len(rows_j) == 4
    for rj, rt in zip(rows_j[1:], rows_t[1:]):
        assert rt[1:] == rj[1:]                     # set timers, zeroed ones, logs
    assert rows_t[2][0] == rows_j[2][0] == "0.000000"   # the skipped stage reads 0


def test_stop_timer_fences_only_a_cuda_tensor(monkeypatch):
    waited = []
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: waited.append(device))
    mon = PerformanceMonitor("t", None)
    mon.start_timer("x")
    assert mon.stop_timer("x", fence=torch.zeros(1)) >= 0.0
    mon.start_timer("x")
    mon.stop_timer("x")
    assert waited == []                              # a CPU tensor needs no wait
    trace.fence_wait(None)
    assert waited == []


#: the JAX handler's stages that the port's whole step subsumes (never timed)
DEAD = {"fused_frame_step", "sparse_img_align", "reproject", "pose_optimizer", "seed_update",
        "host_tail"}


def test_handler_trace_columns_equal_and_env(tmp_path, monkeypatch):
    """The port's header is ``trace_columns()``: the JAX handler's logs first
    and in order, its timed stages in order less the ones the port never
    runs, then the port's own spans, device columns and counters."""
    hj = JaxHandler(JaxCamera(64, 48, 40.0, 40.0, 32.0, 24.0), JaxConfig())
    hj.enable_tracing(trace_name="h", trace_dir=str(tmp_path / "j"))
    assert FrameHandler.TRACE_LOGS[:len(JaxHandler.TRACE_LOGS)] == JaxHandler.TRACE_LOGS
    kept = [t for t in JaxHandler.TRACE_TIMERS if t not in DEAD]
    assert [t for t in FrameHandler.TRACE_TIMERS if t in JaxHandler.TRACE_TIMERS] == kept
    assert DEAD <= set(JaxHandler.TRACE_TIMERS) and not DEAD & set(FrameHandler.TRACE_TIMERS)
    monkeypatch.setenv("HSO_TRACE", "1")
    monkeypatch.setenv("HSO_TRACE_DIR", str(tmp_path / "t"))
    ht = FrameHandler(PinholeCamera(64, 48, 40.0, 40.0, 32.0, 24.0), Config(), device="cpu")
    assert ht.monitor is not None and ht.monitor.trace_name == "hso_tpu_trace"
    ht.monitor.close()
    ht.enable_tracing(trace_name="h", trace_dir=str(tmp_path / "t"))
    hj.monitor.close()
    ht.monitor.close()
    with open(tmp_path / "j" / "h.csv") as fj, open(tmp_path / "t" / "h.csv") as ft:
        header_j, header_t = fj.read().split(), ft.read().split()
    assert header_t == [",".join(FrameHandler.trace_columns())]
    logs_j = [c for c in header_j[0].split(",") if c.startswith("log_")]
    assert [c for c in header_t[0].split(",") if c.startswith("log_")][:len(logs_j)] == logs_j
    assert os.path.exists(tmp_path / "t" / "hso_tpu_trace.csv")


def test_tracing_off_times_nothing(monkeypatch):
    monkeypatch.delenv("HSO_TRACE", raising=False)
    h = FrameHandler(PinholeCamera(64, 48, 40.0, 40.0, 32.0, 24.0), Config(), device="cpu")
    assert h.monitor is None
    with h._t("host_prep"):
        pass


@pytest.mark.parametrize("stage", ["first", "second"])
def test_handler_logs_a_row_per_frame(tmp_path, stage):
    """Frames through the bootstrap stages: one row each, the JAX logs."""
    from hso_tpu_torch.utils.synthetic import PlaneScene

    cam = PinholeCamera(640, 480, 400.0, 400.0, 320.0, 240.0)
    scene = PlaneScene(cam, z0=2.0, extent=4.0, seed=21)
    h = FrameHandler(cam, Config(), device="cpu")
    h.enable_tracing(trace_name="r", trace_dir=str(tmp_path))
    n = 1 if stage == "first" else 2
    for k in range(n):
        h.add_image(scene.render(np.eye(4)[:3]), ts=float(k))
    h.monitor.close()
    with open(tmp_path / "r.csv") as fh:
        rows = list(csv.DictReader(fh))
    assert len(rows) == n
    assert [float(r["log_frame_id"]) for r in rows] == list(range(n))
    assert all(float(r["timer_tot_time"]) > 0 and float(r["timer_pyramid_creation"]) > 0
               for r in rows)
    assert float(rows[0]["log_is_keyframe"]) == 1.0


# ---------------------------------------------------------------- a made-up clock
class _Event:
    __slots__ = ("t",)


class FakeClock:
    """A made-up event clock in the monitor's interface: an event recorded
    takes its device second from ``device_s`` (of the host second), and is
    done when ``done`` says so; events come from a pool, as on the card."""

    def __init__(self, device_s=lambda h: h, done=lambda ev: True):
        self.device_s, self._done = device_s, done
        self.free, self.made = [], 0

    def _event(self, t):
        if self.free:
            ev = self.free.pop()
        else:
            ev = _Event()
            self.made += 1
        ev.t = t
        return ev

    def anchor(self):
        h = trace.perf_counter()
        return self._event(self.device_s(h)), h

    def record(self):
        return self._event(self.device_s(trace.perf_counter()))

    def done(self, ev):
        return self._done(ev)

    @staticmethod
    def elapsed_s(a, b):
        return b.t - a.t

    def release(self, ev):
        self.free.append(ev)


class HostClock:
    """A scripted ``perf_counter``: the monitor reads ``t``."""

    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def scripted_monitor(monkeypatch, tmp_path, device_s, done=lambda ev: True, fence=True):
    host = HostClock()
    monkeypatch.setattr(trace, "perf_counter", host)
    clock = FakeClock(device_s, done)
    monkeypatch.setattr(trace, "device_clock", lambda device: clock)
    mon = PerformanceMonitor("s", str(tmp_path), device="cuda", fence=fence)
    for t in ("outer", "gpu", "wait"):
        mon.add_timer(t)
    mon.add_device("gpu")
    return mon, host, clock


def at(host, t, fn, *a):
    host.t = t
    return fn(*a)


def gpu_on(mon):
    """Enter the host span and the device span ``gpu`` together."""
    mon.start_timer("gpu")
    mon.start_device("gpu")


def gpu_off(mon):
    mon.stop_device("gpu")
    mon.stop_timer("gpu")


def made_up_run(mon, host):
    """Two rows on a device clock 40 s ahead of the host's (host second of
    each device event in the comments): row 1 enters ``gpu`` twice inside
    ``outer``, with a host ``wait`` between; row 2 once, outside any span."""
    at(host, 10.0, mon.init)                                   # anchor: device 50.0
    at(host, 11.0, mon.new_frame)
    at(host, 11.0, mon.start_timer, "outer")
    at(host, 11.1, gpu_on, mon)                                # device reaches it at 11.2
    at(host, 11.3, gpu_off, mon)                               # ... at 11.35
    at(host, 11.3, mon.start_timer, "wait")
    at(host, 11.7, mon.stop_timer, "wait")
    at(host, 11.75, gpu_on, mon)                               # ... at 11.75
    at(host, 11.8, gpu_off, mon)                               # ... at 11.95
    at(host, 11.85, mon.stop_timer, "outer")
    at(host, 11.9, mon.update_finished)
    at(host, 12.0, mon.new_frame)
    at(host, 12.1, gpu_on, mon)                                # ... at 12.1
    at(host, 12.2, gpu_off, mon)                               # ... at 12.5
    at(host, 12.6, mon.update_finished)
    at(host, 13.0, mon.close)                                  # anchor: device 52.9999


DEVICE_AT = {10.0: 50.0, 11.1: 51.2, 11.3: 51.35, 11.75: 51.75, 11.8: 51.95, 12.1: 52.1,
             12.2: 52.5, 13.0: 52.9999}


def read_rows(path):
    with open(path) as fh:
        return [{k: float(v) for k, v in r.items()} for r in csv.DictReader(fh)]


def test_rows_reach_the_file_only_at_close(monkeypatch, tmp_path):
    mon, host, _ = scripted_monitor(monkeypatch, tmp_path, DEVICE_AT.get)
    at(host, 10.0, mon.init)
    at(host, 11.0, mon.new_frame)
    at(host, 11.5, mon.update_finished)
    assert not os.path.exists(mon.path) and len(mon.rows) == 1
    at(host, 13.0, mon.close)
    assert len(read_rows(mon.path)) == 1
    mon.update_finished()                       # after close: nothing more
    assert len(read_rows(mon.path)) == 1


def test_spans_device_intervals_and_row_figures(monkeypatch, tmp_path):
    """A span entered twice adds; device seconds on the host's clock through
    the anchor; ``dev_busy`` the union of a row's device intervals;
    ``timer_host_self`` the row's host time less what device intervals
    (of any row) cover, host spans inside it counted as its own; the skew
    between the two anchors; the row figures appended to the header."""
    mon, host, _ = scripted_monitor(monkeypatch, tmp_path, DEVICE_AT.get)
    made_up_run(mon, host)
    r1, r2 = read_rows(mon.path)
    assert r1["timer_gpu"] == pytest.approx(0.2 + 0.05)
    assert r1["dev_gpu"] == pytest.approx(0.15 + 0.2)
    assert r1["dev_busy"] == pytest.approx(0.35)
    assert r1["timer_host_self"] == pytest.approx(0.9 - 0.15 - 0.15)
    assert r2["dev_gpu"] == pytest.approx(0.4) and r2["timer_gpu"] == pytest.approx(0.1)
    assert r2["timer_host_self"] == pytest.approx(0.6 - 0.4)
    assert r1["timer_wait"] == pytest.approx(0.4) and r2["timer_outer"] == 0.0
    assert mon.rows[0].dev[0][1:] == [pytest.approx(11.2), pytest.approx(11.35)]
    assert mon.skew_s == pytest.approx(3.0 - 2.9999)
    with open(mon.path) as fh:
        assert fh.readline().split() == [
            "timer_outer,timer_gpu,timer_wait,dev_gpu,dev_busy,timer_host_self"]


def test_device_span_records_no_host_time(monkeypatch, tmp_path):
    """A device span alone: its events and ``dev_``, no ``timer_`` and no
    host span; a name never registered records nothing."""
    mon, host, clock = scripted_monitor(monkeypatch, tmp_path, lambda h: h + 40.0)
    at(host, 10.0, mon.init)
    at(host, 11.0, mon.new_frame)
    at(host, 11.1, mon.start_device, "gpu")
    at(host, 11.4, mon.stop_device, "gpu")
    at(host, 11.5, mon.start_device, "other")
    at(host, 11.6, mon.stop_device, "other")
    at(host, 12.0, mon.update_finished)
    at(host, 13.0, mon.close)
    (r,) = read_rows(mon.path)
    assert r["dev_gpu"] == pytest.approx(0.3) and r["timer_gpu"] == 0.0
    assert r["dev_busy"] == pytest.approx(0.3)
    assert r["timer_host_self"] == pytest.approx(1.0 - 0.3)
    assert mon.rows[0].spans == [] and clock.made == 2 + 2


def test_step_graph_device_span_opens_after_the_staging(monkeypatch, tmp_path):
    """The handler's device span around a graph holds its replay alone: the
    inputs are staged before the entry event; the call counts one replay and,
    the first time, the instances captured."""
    from hso_tpu_torch.pipeline.step_graph import StepGraph

    mon, host, clock = scripted_monitor(monkeypatch, tmp_path, lambda h: h + 40.0)
    order = []
    record = clock.record
    monkeypatch.setattr(clock, "record", lambda: (order.append("event"), record())[1])
    g = StepGraph(lambda x: {"y": 2.0 * x}, device="cpu", instances=2, image=False)
    stage, run = g.stage, g.run
    monkeypatch.setattr(g, "stage", lambda *a: (order.append("stage"), stage(*a))[1])
    monkeypatch.setattr(g, "run", lambda inst: (order.append("run"), run(inst))[1])
    h = type("H", (), {"monitor": mon})()
    mon.add_log("graph_replays")
    mon.add_log("graph_captures")
    at(host, 10.0, mon.init)
    at(host, 11.0, mon.new_frame)
    for k in range(2):
        out = FrameHandler._run(h, g, (torch.full((3,), float(k)),), "gpu")
        assert torch.equal(out["y"], torch.full((3,), 2.0 * k))
    at(host, 12.0, mon.update_finished)
    at(host, 13.0, mon.close)
    assert order == ["stage", "event", "run", "event"] * 2
    (r,) = read_rows(mon.path)
    assert r["log_graph_replays"] == 2 and r["log_graph_captures"] == 2
    h.monitor = None
    assert FrameHandler._run(h, g, (torch.ones(3),), "gpu")["y"].sum() == 6.0
    assert order[-2:] == ["stage", "run"]


def test_idle_gaps_name_the_host_span_open_as_they_began(monkeypatch, tmp_path):
    mon, host, _ = scripted_monitor(monkeypatch, tmp_path, DEVICE_AT.get)
    made_up_run(mon, host)
    gaps = mon.idle_gaps(10)
    assert [(round(s, 6), name, round(t, 6)) for s, name, t in gaps] == [
        (0.4, "wait", 0.35), (0.2, "outer", 0.0), (0.15, "(between calls)", 0.95),
        (0.1, "(call)", 1.5)]
    assert len(mon.idle_gaps(2)) == 2


@pytest.mark.parametrize("done", [True, False])
def test_events_are_reused_once_a_row_is_done(monkeypatch, tmp_path, done):
    """Rows whose last event completed are resolved at the next row and their
    events reused: 2 events (and the anchors) serve 50 rows; a device that
    never catches up holds every row's events until ``close`` waits once."""
    t = iter(range(10_000))
    mon, host, clock = scripted_monitor(monkeypatch, tmp_path, lambda h: h + 40.0,
                                        done=lambda ev: done)
    at(host, float(next(t)), mon.init)
    for _ in range(50):
        at(host, float(next(t)), mon.new_frame)
        at(host, float(next(t)), mon.start_device, "gpu")
        at(host, float(next(t)), mon.stop_device, "gpu")
        at(host, float(next(t)), mon.update_finished)
    assert len(mon._pending) == (1 if done else 50)
    at(host, float(next(t)), mon.close)
    assert clock.made == (2 + 2 if done else 100 + 2)
    rows = read_rows(mon.path)
    assert len(rows) == 50 and all(r["dev_gpu"] == pytest.approx(1.0) for r in rows)


@pytest.mark.parametrize("fence", [True, False])
def test_fence_false_never_waits(monkeypatch, tmp_path, fence):
    """With ``fence=True`` every stop waits on its fence; with ``False`` the
    monitor never waits on a stream or the device between init and close."""
    calls = []
    monkeypatch.setattr(trace, "fence_wait", lambda t: calls.append("fence"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append("synchronize"))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: calls.append("stream"))
    mon, host, _ = scripted_monitor(monkeypatch, tmp_path, DEVICE_AT.get, fence=fence)
    at(host, 10.0, mon.init)
    at(host, 11.0, mon.new_frame)
    with mon.timing("outer", torch.zeros(1)):
        with mon.timing("gpu", torch.zeros(1)), mon.device("gpu"):
            pass
    mon.update_finished()
    assert calls == (["fence", "fence"] if fence else [])


def test_tracing_off_takes_no_event_clock_or_timestamp(monkeypatch):
    """Tracing off: no CUDA event, no event clock, no monitor timestamp, no
    handler timestamp, through the bootstrap's two frames."""
    from hso_tpu_torch.pipeline import frame_handler as fh
    from hso_tpu_torch.utils.synthetic import PlaneScene

    def refuse(*a, **k):
        raise AssertionError("tracing off took a timestamp or an event")

    monkeypatch.delenv("HSO_TRACE", raising=False)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(trace, "device_clock", refuse)
    monkeypatch.setattr(trace, "perf_counter", refuse)
    monkeypatch.setattr(fh, "time", type("NoClock", (), {"perf_counter": staticmethod(refuse)}))
    cam = PinholeCamera(640, 480, 400.0, 400.0, 320.0, 240.0)
    scene = PlaneScene(cam, z0=2.0, extent=4.0, seed=21)
    h = FrameHandler(cam, Config(), device="cpu")
    assert h.monitor is None
    for k in range(2):
        h.add_image(scene.render(np.eye(4)[:3]), ts=float(k))


# ---------------------------------------------------------------- the handler's lag-1 loop
@pytest.fixture(scope="module")
def lag1(tmp_path_factory):
    """A handler resumed from the bench checkpoint, its graphs on (the CPU
    instance path), traced with ``fence=False`` through the lag-1 loop until
    two frames past its first keyframe event; device events on a made-up clock
    that reaches each event as it is recorded.  Every stream or device wait
    the monitor could make is recorded."""
    from hso_tpu_torch.bench import BOOT_NPZ, bench_camera, bench_scene, trajectory
    from hso_tpu_torch.pipeline.frame_handler import RESULT_KEYFRAME
    from hso_tpu_torch.utils.checkpoint import load_checkpoint

    tmp = tmp_path_factory.mktemp("lag1")
    waits = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trace, "device_clock", lambda device: FakeClock())
        mp.setattr(trace, "fence_wait", lambda t: waits.append("fence"))
        mp.setattr(torch.cuda, "synchronize", lambda *a: waits.append("synchronize"))
        mp.setattr(torch.cuda, "current_stream", lambda *a: waits.append("stream"))
        h = FrameHandler(bench_camera(), Config(), device="cpu")
        load_checkpoint(h, BOOT_NPZ, resume_stage="default")
        h._graph = True
        start = h.frame_count
        frames = [bench_scene(bench_camera()).render(T)
                  for T in trajectory(start + 14)[start:]]
        h.enable_tracing(trace_name="lag1", trace_dir=str(tmp), fence=False)
        results, calls, event = [], 0, None
        for k, img in enumerate(frames):
            r = h.add_image_pipelined(img, ts=float(start + k))
            calls += 1
            results += [r] if r is not None else []
            if event is None:
                event = next((i for i, x in enumerate(results)
                              if x.status == RESULT_KEYFRAME), None)
            if event is not None and k >= event + 2:
                break
        results += h.flush()
        h.monitor.close()
    assert event is not None, [r.status for r in results]
    return dict(h=h, mon=h.monitor, rows=read_rows(h.monitor.path), results=results,
                calls=calls, start=start, waits=waits)


def test_lag1_trace_holds_no_wait_of_the_monitor(lag1):
    assert lag1["waits"] == []
    with open(lag1["mon"].path) as fh:
        assert fh.readline().rstrip("\n").split(",") == FrameHandler.trace_columns()
    assert len(lag1["rows"]) == lag1["calls"]


def test_pipelined_row_logs_the_frame_it_finalised(lag1):
    rows, results, start = lag1["rows"], lag1["results"], lag1["start"]
    assert rows[0]["log_frame_id"] == 0.0 and rows[0]["timer_sync_packed"] == 0.0
    for j, (row, res) in enumerate(zip(rows[1:], results), start=1):
        assert row["log_frame_id"] == start + j - 1
        assert row["log_n_matches"] == res.n_matches and row["log_n_inliers"] == res.n_inliers
        assert row["log_is_keyframe"] == (res.status == "keyframe")
        assert row["log_err_px"] == pytest.approx(res.err_px, abs=1e-6)
        assert row["timer_sync_packed"] > 0.0 and row["log_host_waits"] >= 1


def test_lag1_rows_split_the_event_and_count(lag1):
    rows, mon = lag1["rows"], lag1["mon"]
    ev = [j for j, r in enumerate(rows) if r["timer_kf_event"] > 0.0]
    assert len(ev) == 1
    e = rows[ev[0]]
    parts = e["timer_ba_assemble"] + e["timer_ba_solve"] + e["timer_ba_readback"]
    assert 0.0 < parts <= e["timer_local_ba"] and min(
        e["timer_ba_assemble"], e["timer_ba_solve"], e["timer_ba_readback"]) > 0.0
    assert e["log_ba_obs"] > e["log_ba_points"] >= 8
    # the map work's dispatch and finish, one column: the two spans add
    spans = [s for s in mon.rows[ev[0]].spans if s[0] == "feature_detection"]
    assert len(spans) == 2
    assert e["timer_feature_detection"] == pytest.approx(sum(s[3] - s[2] for s in spans),
                                                         abs=2e-6)
    assert e["dev_kf_map"] > 0.0 and e["dev_ba_solve"] > 0.0
    # the event's map, backfill and BA graphs captured at their first call
    assert e["log_graph_captures"] >= 3 and e["log_graph_replays"] >= 4
    assert rows[0]["log_graph_captures"] == 2          # the step's two instances
    for r in rows:
        assert r["dev_step_graph"] > 0.0 and r["log_h2d_bytes"] > 0.0
        assert r["dev_busy"] >= r["dev_step_graph"] - 1e-6
        assert 0.0 <= r["timer_host_self"] <= r["timer_tot_time"] + 1e-3
        assert r["log_graph_replays"] >= 1
    plain = [r for r in rows[1:] if r["timer_kf_event"] == 0.0]
    assert all(r["log_graph_replays"] == 1 and r["log_graph_captures"] == 0 for r in plain)
    gaps = lag1["mon"].idle_gaps(10)
    names = set(FrameHandler.TRACE_TIMERS) | {"(call)", "(between calls)"}
    assert 0 < len(gaps) <= 10 and all(name in names for _, name, _ in gaps)
    assert [g[0] for g in gaps] == sorted((g[0] for g in gaps), reverse=True)


def test_failed_lag1_frame_and_its_reprocess_log_a_row_each(tmp_path):
    """A lag-1 call that finalises a failed frame ends its row with that
    frame; the synchronous reprocess of the call's image logs a row of its
    own: every finalised frame once, in order."""
    from hso_tpu_torch.bench import BOOT_NPZ, bench_camera, bench_scene, trajectory
    from hso_tpu_torch.pipeline.frame_handler import RESULT_FAILURE
    from hso_tpu_torch.utils.checkpoint import load_checkpoint

    h = FrameHandler(bench_camera(), Config(), device="cpu")
    load_checkpoint(h, BOOT_NPZ, resume_stage="default")
    h._graph = True
    start = h.frame_count
    frames = [bench_scene(bench_camera()).render(T) for T in trajectory(start + 4)[start:]]
    frames[2] = np.zeros_like(frames[2])                 # a black frame: tracking fails
    h.enable_tracing(trace_name="fail", trace_dir=str(tmp_path), fence=False)
    results = []
    for k, img in enumerate(frames):
        r = h.add_image_pipelined(img, ts=float(start + k))
        results += [r] if r is not None else []
    results += h.flush()
    h.monitor.close()
    rows = read_rows(h.monitor.path)
    assert [r.status == RESULT_FAILURE for r in results] == [False, False, True, False]
    assert len(rows) == len(frames) + 1                  # the failing call logs two
    assert [r["log_frame_id"] for r in rows] == [0.0] + [start + k for k in range(4)]
    for row, res in zip(rows[1:], results):
        assert row["log_n_matches"] == res.n_matches and row["timer_tot_time"] > 0.0

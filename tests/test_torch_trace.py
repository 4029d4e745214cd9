"""Tracing: the port's ``PerformanceMonitor`` against the JAX package's
(``hso_tpu/utils/trace.py``) on the same calls, and the handler's trace
columns against the JAX handler's.  Headers and logged values must be equal
as text; timer columns equal where they are set to a value, zero where a
stage did not run."""

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


def test_handler_trace_columns_equal_and_env(tmp_path, monkeypatch):
    hj = JaxHandler(JaxCamera(64, 48, 40.0, 40.0, 32.0, 24.0), JaxConfig())
    hj.enable_tracing(trace_name="h", trace_dir=str(tmp_path / "j"))
    assert FrameHandler.TRACE_TIMERS == JaxHandler.TRACE_TIMERS
    assert FrameHandler.TRACE_LOGS == JaxHandler.TRACE_LOGS
    monkeypatch.setenv("HSO_TRACE", "1")
    monkeypatch.setenv("HSO_TRACE_DIR", str(tmp_path / "t"))
    ht = FrameHandler(PinholeCamera(64, 48, 40.0, 40.0, 32.0, 24.0), Config(), device="cpu")
    assert ht.monitor is not None and ht.monitor.trace_name == "hso_tpu_trace"
    ht.monitor.close()
    ht.enable_tracing(trace_name="h", trace_dir=str(tmp_path / "t"))
    hj.monitor.close()
    ht.monitor.close()
    with open(tmp_path / "j" / "h.csv") as fj, open(tmp_path / "t" / "h.csv") as ft:
        assert ft.read() == fj.read()
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

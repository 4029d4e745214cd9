"""Performance tracing: named timers and per-frame log columns, one CSV row a
frame (the JAX package's ``PerformanceMonitor``, the same columns and CSV).

A timer stopped with a ``fence`` tensor first waits for the work queued on
that tensor's CUDA stream, so a stage's time includes its device work; a CPU
tensor needs no wait.  The handler passes a fence only while tracing is on.
"""

from __future__ import annotations

import os
import tempfile
import time

import torch


def fence_wait(t) -> None:
    """Wait for the work queued on the current stream of ``t``'s CUDA device."""
    if isinstance(t, torch.Tensor) and t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()


class PerformanceMonitor:
    def __init__(self, trace_name: str = "hso_tpu", trace_dir: str | None = None):
        self.trace_name = trace_name
        self.trace_dir = tempfile.gettempdir() if trace_dir is None else trace_dir
        self._timers: dict[str, float] = {}
        self._starts: dict[str, float] = {}
        self._logs: dict[str, float] = {}
        self._columns: list[str] = []
        self._fh = None

    @property
    def path(self) -> str:
        return os.path.join(self.trace_dir, f"{self.trace_name}.csv")

    def add_timer(self, name: str) -> None:
        self._columns.append(f"timer_{name}")
        self._timers[name] = 0.0

    def add_log(self, name: str) -> None:
        self._columns.append(f"log_{name}")
        self._logs[name] = 0.0

    def init(self) -> None:
        os.makedirs(self.trace_dir, exist_ok=True)
        self._fh = open(self.path, "w")
        self._fh.write(",".join(self._columns) + "\n")

    def new_frame(self) -> None:
        """Zero all timers and logs so stages skipped this frame read 0."""
        for k in self._timers:
            self._timers[k] = 0.0
        for k in self._logs:
            self._logs[k] = 0.0

    def start_timer(self, name: str) -> None:
        self._starts[name] = time.perf_counter()

    def stop_timer(self, name: str, fence=None) -> float:
        fence_wait(fence)
        dt = time.perf_counter() - self._starts.pop(name, time.perf_counter())
        self._timers[name] = dt
        return dt

    def log(self, name: str, value: float) -> None:
        self._logs[name] = float(value)

    def set_timer(self, name: str, seconds: float) -> None:
        """Record an externally measured duration."""
        self._timers[name] = float(seconds)

    def timing(self, name: str, fence=None):
        """Context manager: ``with monitor.timing('stage', fence): ...``."""
        mon = self

        class _Ctx:
            def __enter__(self):
                mon.start_timer(name)

            def __exit__(self, *a):
                mon.stop_timer(name, fence)

        return _Ctx()

    def update_finished(self) -> None:
        """Flush one CSV row."""
        if self._fh is None:
            return
        row = []
        for c in self._columns:
            kind, name = c.split("_", 1)
            src = self._timers if kind == "timer" else self._logs
            row.append(f"{src.get(name, 0.0):.6f}")
        self._fh.write(",".join(row) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

"""Performance tracing: spans, device intervals and per-call columns, one CSV
row a call (the JAX package's ``PerformanceMonitor``: the same calls, and the
same CSV for the same columns).

**Spans.** ``timing(name)`` (or ``start_timer``/``stop_timer``) is a span: its
name, its parent (the innermost span open at its start), its host start and
end (``perf_counter``).  Its seconds add to ``timer_<name>``, so a span
entered twice in one row adds.

**Device spans.** ``device(name)`` (or ``start_device``/``stop_device``), for
a name registered by ``add_device``, records on the card a timing CUDA event
on the current stream at its entry and at its exit, with no wait and no host
timestamp.  Its interval runs from the moment the stream reached the entry
event (so work queued before it is not counted) to the moment it reached the
exit event, including any stretch in which the stream had caught up and
waited for the host; so a device span holds the launch of queued device work
(a graph's replay) and no host work.  Its seconds add to ``dev_<name>``.

**One clock.** ``init`` records an event, synchronises and reads
``perf_counter``: that anchors the event clock to the host clock, and every
device interval is stated in host seconds.  ``close`` does it again;
``skew_s`` is the host clock's seconds between the two anchors less the event
clock's.

**Fences.** With ``fence=True`` a span stopped with a ``fence`` tensor first
waits for the work queued on that tensor's CUDA stream, so its host time
includes its device work (a CPU tensor needs no wait).  ``fence=False`` never
waits: the recorder alone.

**Rows.** ``new_frame`` opens a row and ``update_finished`` closes it; a
``new_frame`` inside an open row continues it, and spans outside a row are
not recorded.  Rows stay in memory and reach the CSV at ``close``.  At each
``new_frame`` the rows whose last event has completed are resolved
(``query``, no wait) and their events are reused, so the live events are
bounded by the rows in flight.  A monitor with device spans appends two
figures a row to its columns, computed at ``close``: ``dev_busy``, the union
of the row's device intervals, and ``timer_host_self``, the row's host time
less the part of it that device intervals cover (those of any row: in the
lag-1 loop the previous call's step runs on into this one).
:meth:`PerformanceMonitor.idle_gaps` attributes the device's idle stretches
to host spans.
"""

from __future__ import annotations

import bisect
import os
import tempfile
from time import perf_counter

import torch

#: the row figures a monitor with device spans appends to its columns
ROW_FIGURES = ("dev_busy", "timer_host_self")


def fence_wait(t) -> None:
    """Wait for the work queued on the current stream of ``t``'s CUDA device."""
    if isinstance(t, torch.Tensor) and t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()


def merge(intervals) -> list[list[float]]:
    """The union of (start, end) intervals, sorted and disjoint."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def covered(a: float, b: float, merged: list, starts: list | None = None) -> float:
    """Seconds of [a, b] inside the union ``merged`` (from :func:`merge`;
    ``starts`` its interval starts, for a long union)."""
    if starts is None:
        starts = [s for s, _ in merged]
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    tot = 0.0
    while i < len(merged) and merged[i][0] < b:
        tot += max(0.0, min(b, merged[i][1]) - max(a, merged[i][0]))
        i += 1
    return tot


class CudaEventClock:
    """Timing CUDA events on the current stream of ``device``, from a pool."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._free: list = []

    def anchor(self):
        """(an event recorded now, the host second once it has completed)."""
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        torch.cuda.synchronize(self.device)
        return ev, perf_counter()

    def record(self):
        ev = self._free.pop() if self._free else torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    @staticmethod
    def done(ev) -> bool:
        return ev.query()

    @staticmethod
    def elapsed_s(a, b) -> float:
        return a.elapsed_time(b) * 1e-3

    def release(self, ev) -> None:
        self._free.append(ev)


def device_clock(device):
    """The event clock of ``device``: None for a device with no events."""
    device = torch.device(device)
    return CudaEventClock(device) if device.type == "cuda" else None


class _Row:
    """One call: column values, spans ``[name, parent, h0, h1]`` and device
    intervals ``[name, entry, exit]`` (events until resolved, then host
    seconds)."""

    __slots__ = ("values", "spans", "dev", "last", "t0", "t1", "resolved")

    def __init__(self, t0: float = 0.0):
        self.values: dict[str, float] = {}
        self.spans: list[list] = []
        self.dev: list[list] = []
        self.last = None           # the event recorded last
        self.t0, self.t1 = t0, None
        self.resolved = True

    def span_at(self, t: float) -> str | None:
        """The innermost span open at host second ``t``."""
        best = None
        for n, _, a, b in self.spans:
            if a <= t < b and (best is None or a >= best[1]):
                best = (n, a)
        return None if best is None else best[0]


class PerformanceMonitor:
    def __init__(self, trace_name: str = "hso_tpu", trace_dir: str | None = None,
                 device=None, fence: bool = True):
        self.trace_name = trace_name
        self.trace_dir = tempfile.gettempdir() if trace_dir is None else trace_dir
        self.fence = bool(fence)
        self.clock = device_clock(device) if device is not None else None
        self.rows: list[_Row] = []
        self.skew_s = None
        self._columns: list[str] = []
        self._device: set[str] = set()
        self._row = _Row()
        self._open = False
        self._stack: list[int] = []
        self._pending: list[_Row] = []     # closed rows with events not yet resolved
        self._anchor = None
        self._closed = False

    @property
    def path(self) -> str:
        return os.path.join(self.trace_dir, f"{self.trace_name}.csv")

    def add_timer(self, name: str) -> None:
        self._columns.append(f"timer_{name}")

    def add_log(self, name: str) -> None:
        self._columns.append(f"log_{name}")

    def add_device(self, name: str) -> None:
        """Column ``dev_<name>``: the device seconds of device span ``name``."""
        self._columns.append(f"dev_{name}")
        self._device.add(name)

    @property
    def columns(self) -> list[str]:
        """The CSV's header."""
        return self._columns + (list(ROW_FIGURES) if self._device else [])

    def init(self) -> None:
        os.makedirs(self.trace_dir, exist_ok=True)
        if self.clock is not None:
            self._anchor = self.clock.anchor()

    # ------------------------------------------------------------------ rows
    def new_frame(self) -> None:
        """Open a row (stages skipped in it read 0), unless one is open."""
        if self._open or self._closed:
            return
        self._resolve(wait=False)
        self._row = _Row(perf_counter())
        self._stack.clear()
        self._open = True

    def update_finished(self) -> None:
        """Close the row; it is written at :meth:`close`."""
        if self._closed:
            return
        row = self._row
        row.t1 = perf_counter()
        if not self._open:
            row.t0 = row.t1
        row.resolved = not row.dev
        self.rows.append(row)
        if not row.resolved:
            self._pending.append(row)
        self._row = _Row()
        self._open = False

    def _drop(self, row: _Row) -> None:
        """Return the events of a row that is discarded."""
        if self.clock is not None:
            for d in row.dev:
                for ev in d[1:]:
                    if ev is not None:
                        self.clock.release(ev)

    def _resolve(self, wait: bool) -> None:
        """State the events of closed rows in host seconds, oldest row first,
        and reuse them; without ``wait`` only rows whose last event is done."""
        clock = self.clock
        while self._pending:
            row = self._pending[0]
            if not wait and not clock.done(row.last):
                return
            self._pending.pop(0)
            ev0, h0 = self._anchor
            for d in row.dev:
                a, b = d[1], d[2] if d[2] is not None else d[1]
                d[1] = h0 + clock.elapsed_s(ev0, a)
                d[2] = h0 + clock.elapsed_s(ev0, b)
                clock.release(a)
                if b is not a:
                    clock.release(b)
                key = f"dev_{d[0]}"
                row.values[key] = row.values.get(key, 0.0) + d[2] - d[1]
            row.resolved = True

    # ------------------------------------------------------------------ spans
    def start_timer(self, name: str) -> None:
        if not self._open:
            return
        row = self._row
        parent = self._stack[-1] if self._stack else -1
        self._stack.append(len(row.spans))
        row.spans.append([name, parent, perf_counter(), None])

    def stop_timer(self, name: str, fence=None) -> float:
        row = self._row
        if self.fence:
            fence_wait(fence)
        t = perf_counter()
        if not self._open:
            return 0.0
        for k in range(len(self._stack) - 1, -1, -1):
            span = row.spans[self._stack[k]]
            if span[0] == name:
                del self._stack[k]
                break
        else:
            return 0.0
        span[3] = t
        dt = t - span[2]
        key = f"timer_{name}"
        row.values[key] = row.values.get(key, 0.0) + dt
        return dt

    def timing(self, name: str, fence=None):
        """Context manager: ``with monitor.timing('stage', fence): ...``."""
        return _Timing(self, name, fence)

    def start_device(self, name: str) -> None:
        if self._open and self.clock is not None and name in self._device:
            row = self._row
            row.last = self.clock.record()
            row.dev.append([name, row.last, None])

    def stop_device(self, name: str) -> None:
        if self._open and self.clock is not None and name in self._device:
            row = self._row
            for d in reversed(row.dev):
                if d[0] == name and d[2] is None:
                    d[2] = row.last = self.clock.record()
                    break

    def device(self, name: str):
        """Context manager: ``with monitor.device('graph'): graph.replay()``."""
        return _Device(self, name)

    # ------------------------------------------------------------------ values
    def log(self, name: str, value: float) -> None:
        self._row.values[f"log_{name}"] = float(value)

    def count(self, name: str, n: float = 1) -> None:
        """Add ``n`` to the row's ``log_<name>``."""
        key = f"log_{name}"
        self._row.values[key] = self._row.values.get(key, 0.0) + n

    def set_timer(self, name: str, seconds: float) -> None:
        """Record an externally measured duration."""
        self._row.values[f"timer_{name}"] = float(seconds)

    # ------------------------------------------------------------------ output
    def close(self) -> None:
        """Wait once, state every row's device intervals on the host clock,
        compute the row figures and write the CSV."""
        if self._closed:
            return
        self._closed = True
        self._drop(self._row)
        if self.clock is not None:
            end = self.clock.anchor()
            self._resolve(wait=True)
            ev0, h0 = self._anchor
            self.skew_s = (end[1] - h0) - self.clock.elapsed_s(ev0, end[0])
        union = merge((d[1], d[2]) for r in self.rows for d in r.dev)
        starts = [a for a, _ in union]
        for r in self.rows:
            busy, host_self = ROW_FIGURES
            r.values[busy] = sum(b - a for a, b in merge((d[1], d[2]) for d in r.dev))
            r.values[host_self] = (r.t1 - r.t0) - covered(r.t0, r.t1, union, starts)
        columns = self.columns
        os.makedirs(self.trace_dir, exist_ok=True)
        with open(self.path, "w") as fh:
            fh.write(",".join(columns) + "\n")
            for r in self.rows:
                fh.write(",".join(f"{r.values.get(c, 0.0):.6f}" for c in columns) + "\n")

    def idle_gaps(self, n: int = 10) -> list[tuple[float, str, float]]:
        """The ``n`` longest stretches in which no device interval was open,
        between the first row's start and the last row's end, longest first:
        (seconds, the innermost host span open when the stretch began, its
        start in seconds from the first row's start).  A stretch that began
        between calls names ``(between calls)``; inside a call but in no
        span, ``(call)``.  Reads the resolved rows (all, after ``close``)."""
        rows = [r for r in self.rows if r.resolved]
        if not rows:
            return []
        w0, w1 = rows[0].t0, rows[-1].t1
        union = merge((d[1], d[2]) for r in rows for d in r.dev)
        edges = [w0] + [min(max(x, w0), w1) for ab in union for x in ab] + [w1]
        gaps = sorted(((b - a, a) for a, b in zip(edges[0::2], edges[1::2]) if b > a),
                      reverse=True)[:n]
        row_starts = [r.t0 for r in rows]
        out = []
        for length, t in gaps:
            r = rows[max(bisect.bisect_right(row_starts, t) - 1, 0)]
            if not r.t0 <= t < r.t1:
                span = "(between calls)"
            else:
                span = r.span_at(t) or "(call)"
            out.append((length, span, t - w0))
        return out


class _Timing:
    __slots__ = ("mon", "name", "fence")

    def __init__(self, mon, name, fence):
        self.mon, self.name, self.fence = mon, name, fence

    def __enter__(self):
        self.mon.start_timer(self.name)

    def __exit__(self, *a):
        self.mon.stop_timer(self.name, self.fence)


class _Device:
    __slots__ = ("mon", "name")

    def __init__(self, mon, name):
        self.mon, self.name = mon, name

    def __enter__(self):
        self.mon.start_device(self.name)

    def __exit__(self, *a):
        self.mon.stop_device(self.name)

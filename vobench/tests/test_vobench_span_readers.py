"""The readers of the handler's spans and row figures, on made-up stage rows.

    python -m pytest vobench/tests -q
"""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from vobench import run  # noqa: E402

SPAN_READERS = ("step.device_ms", "host_loop.ms", "kf_event.map_device_ms", "ba.assemble_ms",
                "ba.solve_device_ms")


def test_span_readers_on_made_up_stage_rows():
    """Medians over plain calls (no event) or over the calls with an event
    or a BA, in ms."""
    plain = dict(timer_kf_event=0.0, timer_local_ba=0.0, dev_kf_map=0.0,
                 timer_ba_assemble=0.0, dev_ba_solve=0.0)
    stages = [dict(plain, dev_step_graph=0.006, timer_host_self=0.004),
              dict(plain, dev_step_graph=0.007, timer_host_self=0.006),
              dict(plain, dev_step_graph=0.0, timer_host_self=0.005),   # no dispatch
              dict(timer_kf_event=0.050, timer_local_ba=0.030, dev_step_graph=0.009,
                   timer_host_self=0.040, dev_kf_map=0.011, timer_ba_assemble=0.020,
                   dev_ba_solve=0.008),
              dict(timer_kf_event=0.060, timer_local_ba=0.0, dev_step_graph=0.009,
                   timer_host_self=0.045, dev_kf_map=0.013, timer_ba_assemble=0.0,
                   dev_ba_solve=0.0)]                                        # event, no BA
    ctx = dict(stages=stages, plain=dict(frames=0, seconds=0.0), profile=None, n_features=336)
    assert run.load_reader("step.device_ms")(ctx) == pytest.approx(6.5)
    assert run.load_reader("host_loop.ms")(ctx) == pytest.approx(5.0)
    assert run.load_reader("kf_event.map_device_ms")(ctx) == pytest.approx(12.0)
    assert run.load_reader("ba.assemble_ms")(ctx) == pytest.approx(20.0)
    assert run.load_reader("ba.solve_device_ms")(ctx) == pytest.approx(8.0)


@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_readers_find_nothing_in_older_stage_rows(name):
    """Stage rows of a program without the spans (the columns before them):
    the reader returns nothing and raises nothing."""
    old = [dict(timer_fused_dispatch=0.008, timer_kf_event=0.0, timer_local_ba=0.0),
           dict(timer_fused_dispatch=0.009, timer_kf_event=0.040, timer_local_ba=0.025)]
    ctx = dict(stages=old, plain=dict(frames=2, seconds=8.0), profile=None, n_features=336)
    assert run.load_reader(name)(ctx) is None
    assert run.load_reader(name)(dict(ctx, stages=[])) is None

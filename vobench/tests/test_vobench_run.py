"""A whole run of the harness, rehearsed on the CPU at a small size, and the
faults its comparison has to catch.

    python -m pytest vobench/tests/test_vobench_run.py -q      (~8 min, one process)

A CPU run measures nothing; these tests hold the harness's bookkeeping and
its ``correct``.  The ``card`` tests run the cells on a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from vobench import run  # noqa: E402

#: a small CPU rehearsal: 48 warm frames (bootstrap and the first events),
#: sixteen seconds of the closed loop at most 2 frames a second, which hold a
#: keyframe event and its windowed-BA solve
SMALL = ["--device", "cpu", "--seconds", "16", "--warm-frames", "48", "--max-fps", "2"]
SEED = 2718281828
WARM = 48


def rehearse(capsys, *extra) -> dict:
    rc = run.main(["--workload", "icl-nuim.replay", "--seed", str(SEED), *SMALL, *extra])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and out
    return json.loads(out[-1])


def test_last_line_parses_on_the_cpu(capsys):
    res = rehearse(capsys)
    assert list(res)[:3] == ["correct", "attempted", "failed"] and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"frames_per_s", "frame_p50_ms", "frame_p95_ms", "setup_s"}
    assert res["device"]["platform"] == "cpu"
    for c in res["checks"].values():
        assert c["value"] is not None and c["value"] <= c["limit"]


def test_no_result_without_a_card_unless_asked(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, os.path.join(ROOT, "vobench", "run.py"), "--workload",
                        "euroc.live", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_no_result_from_the_benchmark_files_alone(tmp_path):
    """A checkout that holds only BENCHMARK.json and vobench/ has no program."""
    import shutil

    shutil.copytree(os.path.join(ROOT, "vobench"), tmp_path / "vobench")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "vobench/run.py", "--workload", "icl-nuim.replay",
                        "--seed", "1", "--seconds", "1", "--trace", "0", "--device", "cpu"],
                       capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def _patch_window_poses(monkeypatch, alter):
    """Break the handler where each timed frame's pose is produced (the lag-1
    loop's finalise): ``alter(k, T, trajectory)`` gives the pose recorded."""
    from hso_tpu_torch.pipeline.frame_handler import FrameHandler

    orig = FrameHandler._finalize_pipelined

    def broken(self, frame, out, ts):
        res = orig(self, frame, out, ts)
        k = int(ts)
        if k >= WARM:
            T = alter(k, self.trajectory[-1][1], self.trajectory)
            self.trajectory[-1] = (ts, T)
            res.T_f_w = T
        return res

    monkeypatch.setattr(FrameHandler, "_finalize_pipelined", broken)


def _last_pose_before(k, traj):
    return next(T for ts, T in reversed(traj[:-1]) if int(ts) < k).copy()


@pytest.mark.parametrize("fault", ["unchanged", "half_left_out", "altered"])
def test_a_broken_timed_path_is_not_correct(capsys, monkeypatch, fault):
    """The faults a cell can have: a step that returns its state unchanged (the
    pose of the frame before), half of the timed frames left out (their poses
    not produced: the frame before's stands), an answer altered where it is
    produced (one timed frame's pose moved by 2 cm in the handler's unit)."""
    if fault == "unchanged":
        _patch_window_poses(monkeypatch, lambda k, T, tr: _last_pose_before(k, tr))
    elif fault == "half_left_out":
        _patch_window_poses(monkeypatch,
                            lambda k, T, tr: _last_pose_before(k, tr) if k % 2 else T)
    else:
        def shift(k, T, tr):
            if k != WARM + 1:
                return T
            T = T.copy()
            T[:, 3] += np.array([0.02, 0.0, 0.0])
            return T
        _patch_window_poses(monkeypatch, shift)
    res = rehearse(capsys)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("control, fails", [("align_cut", "lost_frames"),
                                            ("ba_cut", "ba_cost_gap_max")])
def test_the_control_is_not_correct(capsys, control, fails):
    """The comparison's controls, each a guarantee the configuration states,
    broken: the matcher's subpixel alignment cut to no iteration (tracking is
    lost), the windowed BA cut to no iteration (tracking goes on, and the
    reference finds the solves' decrease undone)."""
    res = rehearse(capsys, "--control", control)
    assert res["correct"] is False, res["checks"]
    c = res["checks"][fails]
    assert c["value"] is not None and c["value"] > c["limit"], res["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell", ["icl-nuim.replay", "euroc.live"])
def test_a_short_run_on_the_card_is_correct(card, cell):
    p = subprocess.run([sys.executable, os.path.join(ROOT, "vobench", "run.py"), "--workload",
                        cell, "--seed", "987654321", "--seconds", "5", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"

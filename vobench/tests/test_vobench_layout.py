"""The benchmark's definition and its frozen yardstick, on the CPU.

    python -m pytest vobench/tests -q
"""

from __future__ import annotations

import ast
import json
import os
import re
import shutil
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from vobench import evaluate, kernels, run, scene, trace, trajectory  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_top_level_keys_and_limits():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["vobench"] and not b["paths"][0].endswith("_torch")
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert len(b["command"]) <= 32 and b["command"][1].startswith("vobench/")
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    # a full check of 24 cells fits its time
    rs = b["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(section):
    b = bench()
    names = [e["name"] for e in b[section]]
    assert len(names) == len(set(names))
    for e in b[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


def test_every_name_resolves_to_its_file():
    b = bench()
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert c["file"] == f"vobench/configs/{c['name']}.json"
        with open(os.path.join(ROOT, c["file"])) as fh:
            conf = json.load(fh)
        assert conf["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    pairs = set()
    for w in b["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        for part in (("traffic", f"{w['traffic']}.json"), ("limits", f"{w['name']}.json")):
            assert os.path.exists(os.path.join(ROOT, "vobench", *part)), part
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(b["workloads"]) // 4)
    for m in b["per_layer"]:
        assert callable(run.load_reader(m["name"]))
    used = {w["config"] for w in b["workloads"]}
    assert used == set(configs)


def test_metric_sources_bounds_and_cells():
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for c in cells:
        reported = {m["name"] for m in run.cell_metrics(b, c, False)}
        assert "setup_s" in reported and len(reported) >= 2
        assert run.cell_metrics(b, c, True), c
    for m in b["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        for c in m.get("workloads", cells):
            assert c in cells
            # each cell that reports this metric reports the end-to-end one it moves
            assert m["moves"] in {x["name"] for x in run.cell_metrics(b, c, False)}, (m, c)
    layers = {}
    for m in b["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert all(len(k.splitlines()) == 1 for k in layers)


def test_adding_a_cell_takes_new_files_and_entries_only(tmp_path, monkeypatch):
    """A new configuration, mix, limit and per-layer metric are new files under
    their folders and new entries in BENCHMARK.json; no file already there
    changes."""
    shutil.copytree(os.path.join(ROOT, "vobench"), tmp_path / "vobench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    before = {p: open(os.path.join(tmp_path, p), "rb").read()
              for p in _files(tmp_path / "vobench", tmp_path)}
    v = tmp_path / "vobench"
    conf = json.loads((v / "configs" / "icl-nuim.json").read_text())
    conf["name"] = "icl-nuim-wide"
    (v / "configs" / "icl-nuim-wide.json").write_text(json.dumps(conf))
    traf = json.loads((v / "traffic" / "replay.json").read_text())
    (v / "traffic" / "slow.json").write_text(json.dumps(dict(traf, warm_frames=100)))
    (v / "limits" / "icl-nuim-wide.slow.json").write_text(
        (v / "limits" / "icl-nuim.replay.json").read_text())
    (v / "metrics" / "extra.ms.py").write_text("def read(ctx):\n    return 1.0\n")
    b["configs"].append(dict(b["configs"][0], name="icl-nuim-wide",
                             file="vobench/configs/icl-nuim-wide.json"))
    b["workloads"].append(dict(b["workloads"][0], name="icl-nuim-wide.slow",
                               config="icl-nuim-wide", traffic="slow"))
    b["per_layer"].append(dict(b["per_layer"][0], name="extra.ms",
                               workloads=["icl-nuim-wide.slow"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    monkeypatch.setattr(run, "ROOT", str(tmp_path))
    nb = run.load_json("BENCHMARK.json")
    assert run.load_json("vobench", "configs", "icl-nuim-wide.json")["name"] == "icl-nuim-wide"
    assert run.load_json("vobench", "traffic", "slow.json")["warm_frames"] == 100
    assert run.load_json("vobench", "limits", "icl-nuim-wide.slow.json")["compare"]
    names = [m["name"] for m in run.cell_metrics(nb, "icl-nuim-wide.slow", True)]
    assert names == ["extra.ms"]
    assert run.load_reader("extra.ms")({}) == 1.0
    after = {p: open(os.path.join(tmp_path, p), "rb").read() for p in before}
    assert after == before


def _files(folder, base):
    for dirpath, _, names in os.walk(folder):
        for n in names:
            if "__pycache__" not in dirpath:
                yield os.path.relpath(os.path.join(dirpath, n), base)


def _top_level_imports(path: str) -> set[str]:
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_no_jax_or_jax_package_import_under_vobench():
    found = {}
    for rel in _files(os.path.join(ROOT, "vobench"), ROOT):
        if rel.endswith(".py"):
            bad = _top_level_imports(os.path.join(ROOT, rel)) & set(run.FORBIDDEN)
            if bad:
                found[rel] = bad
    assert not found, found
    # the whole-name comparison: the port's name begins with the JAX package's
    assert "hso_tpu_torch".split(".")[0] not in run.FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(ROOT, "vobench", "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            mods = _top_level_imports(os.path.join(ref, name))
            assert not mods & {"hso_tpu_torch", "hso_tpu", "jax"}, (name, mods)
    for frozen in ("scene.py", "evaluate.py", "trajectory.py", "kernels.py"):
        assert "hso_tpu_torch" not in _top_level_imports(os.path.join(ROOT, "vobench", frozen))


def test_loaded_forbidden_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "hso_tpu_torch_fake_probe", sys)
    assert "hso_tpu" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "hso_tpu.fake_probe", sys)
    assert "hso_tpu" in run.loaded_forbidden()


@pytest.mark.parametrize("distortion", [(0.0, 0.0, 0.0, 0.0),
                                        (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05)])
def test_renderer_matches_the_port_scene(distortion):
    from hso_tpu_torch.cameras import PinholeCamera
    from hso_tpu_torch.utils.synthetic import BoxScene

    k = (96, 72, 70.0, 69.0, 47.5, 35.5)
    mine = scene.BoxScene(2.0, 1.5, 4.5, seed=11, tex_size=256)
    ref = BoxScene(PinholeCamera(*k, *distortion), half_width=2.0, half_height=1.5, depth=4.5,
                   seed=11, stepped_back=True, tex_size=256)
    with open(os.path.join(ROOT, "vobench", "traffic", "replay.json")) as fh:
        motion = json.load(fh)["motion"]
    gt = trajectory.poses(4, motion, 1.4, 20.0)
    got = mine.render_frames(scene.Camera(*k, distortion), gt).astype(int)
    want = np.stack([ref.render(T) for T in gt]).astype(int)
    assert np.abs(got - want).max() <= 1


def test_trajectory_is_the_bench_sweep():
    from hso_tpu_torch.bench import trajectory as bench_trajectory

    with open(os.path.join(ROOT, "vobench", "traffic", "replay.json")) as fh:
        motion = json.load(fh)["motion"]
    # at 0.6 s a unit and 30 Hz, the bench's 18 frames a unit
    np.testing.assert_allclose(trajectory.poses(50, motion, 0.0, 30.0),
                               np.stack(bench_trajectory(50)), atol=1e-12)
    with open(os.path.join(ROOT, "vobench", "traffic", "hover.json")) as fh:
        hov = json.load(fh)
    n = hov["warm_frames"] + 20
    sched = [[hov["warm_frames"] + f, a] for f, a in hov["motion"]["amplitude_after_warm"]]
    p = trajectory.poses(n, dict(motion, amplitude=sched), 0.2, 30.0)
    sweep = np.abs(np.diff(trajectory.poses(n, motion, 0.2, 30.0), axis=0)).max()
    # the ramp keeps the pose continuous: no step much beyond the sweep's own
    assert np.abs(np.diff(p, axis=0)).max() < 1.6 * sweep
    amp = trajectory.amplitude(np.arange(float(n)), sched)
    assert amp[0] == 1.0 and amp[-1] == pytest.approx(0.1)


def test_frozen_ate_matches_the_port():
    from hso_tpu_torch.utils.evaluate import ate

    rng = np.random.default_rng(4)
    gt = rng.normal(size=(40, 3))
    Rq, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    Rq *= np.sign(np.linalg.det(Rq))
    est = (0.37 * (Rq @ gt.T)).T + rng.normal(scale=0.01, size=gt.shape) + 2.0
    assert evaluate.ate_rmse(est, gt) == pytest.approx(ate(est, gt).rmse, rel=1e-12)
    s, R, t = evaluate.umeyama(est, gt)
    assert s == pytest.approx(1 / 0.37, rel=0.05)


def test_align_errors_of_a_similar_trajectory_are_zero():
    with open(os.path.join(ROOT, "vobench", "traffic", "replay.json")) as fh:
        motion = json.load(fh)["motion"]
    gt = trajectory.poses(30, motion, 0.1, 20.0)
    # the same trajectory in another frame and scale: world' = s R world + t
    S = trajectory.se3_exp(np.array([0.3, -0.2, 0.1, 0.2, 0.1, -0.3]))
    est = np.stack([np.concatenate([T[:, :3] @ S[:, :3].T,
                                    (0.5 * (T[:, 3] - T[:, :3] @ S[:, :3].T @ S[:, 3]))[:, None]],
                                   axis=1) for T in gt])
    al = evaluate.align_errors(est, gt, np.ones(30, bool))
    assert al["pos_m"].max() < 1e-9 and al["rot_deg"].max() < 1e-5
    assert al["scale"] == pytest.approx(2.0)


def test_true_distance_against_the_planes():
    from vobench.reference.check import true_distance

    sc = scene.BoxScene(2.0, 1.5, 4.5, seed=0, tex_size=64)
    T = np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)[None].repeat(3, 0)
    f = np.array([[0.3, 0.0, 1.0], [1.0, 0.0, 0.0], [-0.3, 0.0, 1.0]])
    d = true_distance(sc, T, f)
    assert d[0] == pytest.approx(4.5 * np.sqrt(1.09))          # the far wall, right half
    assert d[1] == pytest.approx(2.0)                          # the right wall
    assert d[2] == pytest.approx(0.55 * 4.5 * np.sqrt(1.09))   # the slab, left half


@pytest.mark.parametrize("name,grid,block,rows", [
    ("void pack_level_windows_kernel<24>(GatherParams)", [42, 1, 1], [256, 1, 1], 336),
    ("void extract_windows_kernel<24>(GatherParams)", [84, 1, 1], [256, 1, 1], 672),
    ("void pack_level_windows_kernel<40>(GatherParams)", [256, 1, 1], [128, 1, 1], 1024),
])
def test_window_kernel_bound_counts_each_row_once(name, grid, block, rows):
    win = int(re.search(r"<(\d+)>", name).group(1))
    per_row = 2 * win * win * 4 + (8 if "extract" in name else 12)
    want = rows * per_row / kernels.PEAK_BYTES_PER_S
    assert kernels.launch_bound_s(name, grid, block, 336) == pytest.approx(want)


def test_kernel_bounds_are_positive_and_others_ignored():
    for name in ("coarse_level_ic_kernel<true, 0>", "align_match_kernel<4>",
                 "pose_lm_kernel", "zmncc_line_kernel"):
        assert kernels.launch_bound_s(name, [8, 1, 1], [256, 1, 1], 336) > 0
    assert kernels.launch_bound_s("ampere_sgemm_64x64_nn", [8, 1, 1], [256, 1, 1], 336) is None
    # K3's bound at the configuration's shape, by bytes: as PERF.md's 0.00026 ms
    assert kernels.launch_bound_s("coarse_level_ic_kernel", [8, 1, 1], [256, 1, 1], 336) \
        == pytest.approx(2.6e-7, rel=0.1)


def _session():
    dev = [dict(name="k1", cat="kernel", start=1.0, end=2.0, grid=[1, 1, 1], block=[32, 1, 1]),
           dict(name="k2", cat="kernel", start=1.5, end=3.0, grid=[1, 1, 1], block=[32, 1, 1]),
           dict(name="m", cat="gpu_memcpy", start=5.0, end=5.5, grid=[1, 1, 1], block=[1, 1, 1])]
    host = [dict(name="aten::copy_", start=3.0, end=4.5), dict(name="outer", start=0.0, end=9.0)]
    return dict(device=dev, host=host, window=(0.5, 6.0))


def test_trace_reduction_takes_the_union_and_the_gaps():
    s = trace.reduce_session(_session())
    assert s["busy_s"] == pytest.approx(2.5)
    assert s["window_s"] == pytest.approx(5.5)
    gaps = dict(s["gaps"])
    assert gaps["aten::copy_"] == pytest.approx(2.0)
    assert trace.merge([(3, 4), (1, 2), (1.5, 2.5)]) == [(1, 2.5), (3, 4)]
    b = trace.breakdown(s)
    assert b["device_ops"][0][0] == "k2" and len(b["idle_gaps"]) <= 10


def test_readers_on_a_made_up_trace():
    stages = [dict(timer_fused_dispatch=0.008, timer_kf_event=0.0, timer_local_ba=0.0),
              dict(timer_fused_dispatch=0.010, timer_kf_event=0.0, timer_local_ba=0.0),
              dict(timer_fused_dispatch=0.009, timer_kf_event=0.040, timer_local_ba=0.025)]
    sess = trace.reduce_session(_session())
    sess["frames"] = 2
    ctx = dict(stages=stages, plain=dict(frames=2, seconds=8.0), profile=sess, n_features=336)
    assert run.load_reader("step.ms")(ctx) == pytest.approx(9.0)
    assert run.load_reader("kf_event.ms")(ctx) == pytest.approx(15.0)
    assert run.load_reader("ba.ms")(ctx) == pytest.approx(25.0)
    assert run.load_reader("device.idle_share")(ctx) == pytest.approx(100 * (1 - 1.25 / 4.0))
    assert run.load_reader("kernels_roofline")(ctx) is None   # no kernel of the port
    empty = dict(ctx, stages=[], profile=None)
    for name in ("step.ms", "kf_event.ms", "ba.ms", "device.idle_share", "kernels_roofline"):
        assert run.load_reader(name)(empty) is None


def test_coarse_features_as_the_handler_grids():
    from hso_tpu_torch.config import Config
    from hso_tpu_torch.pipeline.scan import frame_grid

    for w, h in ((640, 480), (752, 480)):
        cam = type("C", (), dict(width=w, height=h))
        g = frame_grid(cam, Config())
        assert run.coarse_features(w, h, Config().max_fts) == g[1] * g[2]


def test_renderer_runs_on_the_tensors_device():
    sc = scene.BoxScene(2.0, 1.5, 4.5, seed=1, tex_size=64, device="cpu")
    f = scene.Camera(8, 6, 6.0, 6.0, 3.5, 2.5).pixel_bearings("cpu")
    T = torch.from_numpy(trajectory.poses(2, {"seconds_per_unit": 0.6,
                                              "components": [[0.8, 0.8]] + [[0, 1]] * 5},
                                          0.0, 30.0))
    img = sc.render(f, T)
    assert img.shape == (2, 48) and img.dtype == torch.uint8


def test_the_median_session_stands_for_the_profile():
    def sess(n_ops, frames=12):
        return dict(device=[None] * n_ops, frames=frames)

    plain, event = sess(44000), sess(52000)          # one session caught an event
    assert trace.pick_session([plain, event, sess(43999)]) is plain
    assert trace.pick_session([event]) is event and trace.pick_session([]) is None

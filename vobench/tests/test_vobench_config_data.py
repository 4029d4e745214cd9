"""What a configuration, a limits file and the files beside them can state as
data: a FOV camera as the dataset publishes it, the handler's online
photometric calibration, the camera's photometric chain, a compared number of
a ``checks/`` file and a control of the limits file.  On the CPU.

    python -m pytest vobench/tests/test_vobench_config_data.py -q     (~3 min, one process)
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from vobench import run, scene, trajectory  # noqa: E402

CAMERAS = os.path.join(ROOT, "data", "cameras")

#: sha256 of the calibration file and of the first three frames of seeds 1-3
#: that the harness wrote and rendered before configurations could state a
#: FOV camera or a photometric chain (CPU, the full textures)
BEFORE = {
    "icl-nuim": ("442c0363c16b63222263f22c702048865e4e1aa1e7df45bf5c14d431a6173977", [
        "5e09bf29f11b5ddda29e57a4fdbb8c6bcb7e87e9a3e39a69bee0b960905f17c0",
        "e9a8a7c3241b6e6c3c7b1d11e82086a9a380e6c1463eb7b56604cff6292069f8",
        "0a3f0b0159bba02a8610e92d86698498b635a43ab7971473fcbf8d8df6985ac8"]),
    "euroc": ("f236173c2759794d4c45ff1c8be982a67bcfc68c9d03294d49d951c2d358afef", [
        "892a48fb71cc39f56dc4ccef3aa8b4c2d4904cd32c4845389cef40446b245029",
        "3ad882cc88c7c07920e7fd181355f678be3f64fe254eb5cd975cebaecf95cce3",
        "a0050490a22c5d646199324d9e8967955bf60a0267db1f4433a6bdf79768deab"]),
}


def _json(*parts) -> dict:
    with open(os.path.join(ROOT, *parts)) as fh:
        return json.load(fh)


def calibration_of(path: str) -> dict:
    """A dataset's calibration file as a configuration states it."""
    with open(path) as fh:
        lines = [ln.split() for ln in fh if ln.strip()]
    model, vals = lines[0][0], [float(x) for x in lines[0][1:]]
    w, h = (int(x) for x in lines[1][:2])
    if model == "FOV":
        return dict(model="FOV", params=vals, width=w, height=h,
                    rectify=lines[2][0].lower() == "true")
    return dict(model="Pinhole", width=w, height=h, fx=vals[0], fy=vals[1], cx=vals[2],
                cy=vals[3], distortion=vals[4:])


@pytest.mark.parametrize("name", sorted(os.listdir(CAMERAS)))
def test_frozen_camera_and_rescale_are_the_programs(name, tmp_path):
    from hso_tpu_torch.cameras import FOVCamera
    from hso_tpu_torch.io.calib import parse_calib

    cal = calibration_of(os.path.join(CAMERAS, name))
    prog = parse_calib(os.path.join(CAMERAS, name))
    written = tmp_path / "camera.txt"
    written.write_text(run.calibration_text(cal))
    again = parse_calib(str(written))
    mine = scene.camera(cal)
    for c in (again, mine):
        assert (c.width, c.height) == (prog.width, prog.height)
        np.testing.assert_allclose([c.fx, c.fy, c.cx, c.cy],
                                   [prog.fx, prog.fy, prog.cx, prog.cy], rtol=0, atol=1e-12)
    assert getattr(again, "undistort_image", False) == getattr(prog, "undistort_image", False)
    if cal["model"] == "FOV":
        # the frames come from the camera itself: its ATAN model, rectified or not
        assert again.omega == prog.omega
        prog = FOVCamera(prog.width, prog.height, prog.fx, prog.fy, prog.cx, prog.cy,
                         prog.omega)
    v, u = torch.meshgrid(torch.arange(0, mine.height, 7, dtype=torch.float64),
                          torch.arange(0, mine.width, 7, dtype=torch.float64), indexing="ij")
    px = torch.stack([u.reshape(-1), v.reshape(-1)], dim=-1)
    assert (mine.bearings(px) - prog.cam2world(px)).abs().max() <= 1e-12


def _small_scene():
    sc = scene.BoxScene(2.0, 1.5, 4.5, seed=5, tex_size=128)
    cam = scene.camera(dict(model="FOV", params=[0.54, 0.67, 0.49, 0.5, 0.9], width=64,
                            height=48, rectify=False))
    motion = _json("vobench", "traffic", "live.json")["motion"]
    return sc, cam, trajectory.poses(20, motion, 0.1, 20.0)


def _block(**kw) -> dict:
    return dict(dict(vignette=[0.0, 0.0, 0.0], inverse_response=list(range(256)),
                     exposure=dict(log_range=[0.0, 0.0], log_step=0.0, step_seconds=0.5)), **kw)


def test_identity_chain_gives_the_plain_bits():
    sc, cam, gt = _small_scene()
    ph = scene.Photometry(_block(), cam, len(gt), 20.0, np.random.default_rng(0))
    assert np.array_equal(sc.render_frames(cam, gt, chunk=8, photometry=ph),
                          sc.render_frames(cam, gt, chunk=8))
    assert np.all(ph.exposure == 1.0)


def test_chain_inverts_the_response_and_walks_the_exposure():
    sc, cam, gt = _small_scene()
    gamma = 255.0 * (np.arange(256) / 255.0) ** 2.2
    gamma[0] = -1e-3                               # strictly increasing from below 0
    ex = dict(log_range=[-0.4, 0.3], log_step=0.25, step_seconds=0.2)
    ph = scene.Photometry(_block(vignette=[-0.3, 0.05, 0.0], inverse_response=gamma.tolist(),
                                 exposure=ex), cam, len(gt), 20.0, np.random.default_rng(7))
    log_e = np.log(ph.exposure)
    assert log_e[0] == 0.0 and log_e.min() >= -0.4 - 1e-12 and log_e.max() <= 0.3 + 1e-12
    assert len(np.unique(log_e)) > 1 and len(np.unique(log_e[:4])) == 1   # 4 frames a step
    f_c = cam.pixel_bearings("cpu")
    lum = sc.radiance(f_c, torch.from_numpy(gt[2:4]))
    got = ph.observe(lum, 2).numpy()
    v, u = np.mgrid[0:cam.height, 0:cam.width]
    vig = ph.vignette_at((u - cam.cx) ** 2 + (v - cam.cy) ** 2).reshape(-1)
    irr = ph.exposure[2:4, None] * vig[None] * lum.numpy().astype(np.float64)
    want = 255.0 * (irr / 255.0) ** (1 / 2.2)
    ok = irr < 250.0                  # below the top of the curve, where it is not clipped
    assert ok.mean() > 0.9 and np.abs(got - want)[ok].max() < 0.5
    assert ph.vignette_at(0.0) == 1.0 and ph.vignette_at(ph.r2_max) == pytest.approx(0.75)
    with pytest.raises(ValueError):
        scene.Photometry(_block(inverse_response=[0.0] * 256), cam, 4, 20.0,
                         np.random.default_rng(0))


@pytest.mark.parametrize("config, traffic", [("icl-nuim", "replay"), ("euroc", "live")])
def test_existing_configurations_render_and_write_as_before(config, traffic):
    conf = _json("vobench", "configs", f"{config}.json")
    mix = _json("vobench", "traffic", f"{traffic}.json")
    cal_sha, frame_sha = BEFORE[config]
    assert hashlib.sha256(run.calibration_text(conf["calibration"]).encode()).hexdigest() \
        == cal_sha
    assert "photometric" not in conf
    cam = scene.camera(conf["calibration"])
    for seed, want in zip((1, 2, 3), frame_sha):
        phase = float(np.random.default_rng([seed, 1]).uniform(*mix["phase_s"]))
        gt = trajectory.poses(3, mix["motion"], phase, conf["rate_hz"])
        frames = scene.BoxScene(seed=seed, **conf["scene"]).render_frames(cam, gt)
        assert hashlib.sha256(frames).hexdigest() == want, (config, seed)


#: the check a new configuration brings: the log-exposure range its run saw,
#: None where the handler has no online photometric calibration
CHECK = '''import numpy as np


def read(ctx):
    if ctx["handler"].photo is None or ctx["photometric"] is None:
        return None
    return float(np.ptp(np.log(ctx["photometric"].exposure[:len(ctx["statuses"])])))
'''


def test_a_fov_photometric_configuration_is_added_as_data(tmp_path, monkeypatch, capsys):
    """A FOV camera below the rescale, online photometric calibration, the
    photometric chain, a check and a control: new files and new entries only,
    and a CPU rehearsal of the new cell, once as stated and once under its
    control."""
    shutil.copytree(os.path.join(ROOT, "vobench"), tmp_path / "vobench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: (tmp_path / p).read_bytes()
              for p in (os.path.relpath(os.path.join(d, n), tmp_path)
                        for d, _, ns in os.walk(tmp_path / "vobench") for n in ns)}
    v = tmp_path / "vobench"
    conf = _json("vobench", "configs", "icl-nuim.json")
    conf.update(name="fov-photo", rate_hz=20.0,
                calibration=dict(model="FOV", params=[0.535719308086809, 0.669566858850269,
                                                      0.493248545285398, 0.500408664348414,
                                                      0.897966326944875],
                                 width=640, height=512, rectify=False),
                photometric=_block(vignette=[-0.2, 0.0, 0.0],
                                   exposure=dict(log_range=[-0.2, 0.2], log_step=0.1,
                                                 step_seconds=1.0)))
    conf["handler"]["photometric_calib"] = True
    (v / "configs" / "fov-photo.json").write_text(json.dumps(conf))
    (v / "checks").mkdir()
    (v / "checks" / "exposure_log_range.py").write_text(CHECK)
    limits = _json("vobench", "limits", "icl-nuim.replay.json")
    limits["compare"]["exposure_log_range"] = 1.0
    limits["controls"] = dict(photo_off=dict(photometric_calib=False))
    (v / "limits" / "fov-photo.live.json").write_text(json.dumps(limits))
    b = _json("BENCHMARK.json")
    b["configs"].append(dict(b["configs"][0], name="fov-photo",
                             file="vobench/configs/fov-photo.json"))
    b["workloads"].append(dict(b["workloads"][1], name="fov-photo.live", config="fov-photo"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    monkeypatch.setattr(run, "ROOT", str(tmp_path))

    def rehearse(seconds, warm, *extra):
        rc = run.main(["--workload", "fov-photo.live", "--seed", "3141592653", "--device", "cpu",
                       "--seconds", seconds, "--warm-frames", warm, *extra])
        out, err = capsys.readouterr()
        assert rc == 0, err[-3000:]
        return json.loads(out.strip().splitlines()[-1]), err

    # the camera's rate, 48 warm frames (bootstrap, the first photometric solves)
    # and 30 in the window with keyframe events: it tracks and passes
    res, err = rehearse("1.5", "48")
    assert "640x512" in err and "sha256: frames" in err
    c = res["checks"]["exposure_log_range"]
    assert c["value"] is not None and 0.0 < c["value"] <= c["limit"], res["checks"]
    assert set(res["checks"]) == set(limits["compare"]) and res["correct"] is True, res["checks"]
    # the control's handler has no calibration, so the check finds nothing to read
    res, _ = rehearse("0.2", "4", "--control", "photo_off")
    assert res["checks"]["exposure_log_range"]["value"] is None and res["correct"] is False
    rc = run.main(["--workload", "fov-photo.live", "--seed", "1", "--device", "cpu",
                   "--seconds", "1", "--control", "no_such_control"])
    assert rc == 2 and capsys.readouterr().out == ""
    assert {p: (tmp_path / p).read_bytes() for p in before} == before

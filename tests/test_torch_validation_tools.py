"""The validation drivers and dataset tools of ``hso_tpu_torch/tools`` against
the JAX package's scripts they port (CPU).

The JAX scripts are imported from ``scripts/`` here only, with the JAX
compilation cache they set pinned to a temporary directory while they import
and the configuration restored after.  Held:

* the torture chain (``tools/torture.py``) against ``Torture`` of
  ``scripts/make_hard_artifact.py``: the same exposure walk, vignette and
  generator draws exactly; OpenCV's blur and ``filter2D`` rebuilt in scipy to
  float32 rounding (scipy sums in float64), so a corrupted frame is the
  reference's but where a sum lands within rounding of a whole grey level;
* the photo-curve chain (``tools/make_photo_curve_artifact.py``) against
  ``log_u_gt``/``response_lut`` and the corruption of the JAX script, and its
  curve-recovery errors against the JAX script's formulas;
* the pendulum trajectory of ``scripts/ab_patch_source.py``, exactly;
* ``tools/evaluate_ate.py`` against ``scripts/evaluate_ate.py`` on one
  trajectory pair (Sim3 and SE3, EuRoC csv ground truth);
* ``tools/visualize.py`` writing a PNG and a PLY from
  ``artifacts/bench_boot.npz`` (the points and keyframe centres of the JAX
  script's reader);
* ``tools/single_sequence.sh`` on 6 frames of the synthetic PNG sequence.
"""

import contextlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from hso_tpu.photometric.online_calib import _resp_basis as jax_resp_basis
from hso_tpu.photometric.online_calib import _vig_basis as jax_vig_basis
from hso_tpu_torch.bench import bench_camera
from hso_tpu_torch.io.image_reader import read_png
from hso_tpu_torch.tools import ab_patch_source, evaluate_ate, make_photo_curve_artifact, \
    torture, visualize
from hso_tpu_torch.tools import make_synthetic_dataset as gen
from hso_tpu_torch.utils.evaluate import load_tum

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOOT_NPZ = os.path.join(ROOT, "artifacts", "bench_boot.npz")
_PINNED = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")


@contextlib.contextmanager
def pinned_jax_cache(tmp_dir):
    """While the block runs, a JAX script's ``jax.config.update`` of the
    compilation cache goes to ``tmp_dir``; afterwards the configuration the
    tests run with is back."""
    saved = {k: getattr(jax.config, k) for k in _PINNED}
    update = jax.config.update

    def pinned(name, value):
        update(name, str(tmp_dir) if name == "jax_compilation_cache_dir" else value)

    jax.config.update = pinned
    try:
        yield
    finally:
        del jax.config.update
        for k, v in saved.items():
            jax.config.update(k, v)


@pytest.fixture(scope="module")
def scripts(tmp_path_factory):
    """The JAX scripts, imported from ``scripts/`` by file."""
    mods = {}
    with pinned_jax_cache(tmp_path_factory.mktemp("jax_cache")):
        for name in ("make_hard_artifact", "make_photo_curve_artifact", "ab_patch_source",
                     "evaluate_ate", "visualize"):
            spec = importlib.util.spec_from_file_location(
                f"jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
            mods[name] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mods[name])
    assert jax.config.jax_compilation_cache_dir == os.path.join(ROOT, ".jax_cache")
    return mods


def clean_frames(cam, n, seed=4):
    """Textured frames of ``cam``'s size (blurred noise), uint8."""
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    return [np.clip(ndimage.gaussian_filter(rng.uniform(0, 255, (cam.height, cam.width)), 2.0),
                    0, 255).astype(np.uint8) for _ in range(n)]


# ---------------------------------------------------------------- torture
@pytest.mark.parametrize("level", ["hard", "extreme"])
def test_torture_chain_matches_the_jax_script(scripts, level):
    cam = bench_camera()
    n = 48
    ref = scripts["make_hard_artifact"].Torture(cam, n, level)
    ours = torture.Torture(cam, n, level)
    assert torture.LEVELS == scripts["make_hard_artifact"].LEVELS
    np.testing.assert_array_equal(ours.log_e, ref.log_e)
    np.testing.assert_array_equal(ours.vig, ref.vig)
    np.testing.assert_allclose(ours.occ_tex, ref.occ_tex, rtol=0, atol=1e-4)
    frames = clean_frames(cam, 5)
    # slow, diagonal, horizontal (even kernel), vertical and fast image velocities
    for k, vel in enumerate([(0.5, 0.2), (3.0, 1.0), (-5.6, 0.1), (0.3, 4.2), (9.0, -6.0)]):
        got = ours(frames[k], 7 * k, np.array(vel))
        want = ref(frames[k], 7 * k, np.array(vel))
        d = np.abs(got.astype(int) - want.astype(int))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-4, (k, d.max(), (d > 0).mean())
    # the two generators drew the same numbers in the same order
    assert ours.rng.random() == ref.rng.random()


def test_image_velocities_are_the_scripts(scripts):
    from hso_tpu_torch.bench import trajectory

    cam = bench_camera()
    poses = trajectory(12)
    ms = scripts["make_hard_artifact"]
    cs = [ms.se3np.translation(ms.se3np.inv(T)) for T in poses]
    want = [np.zeros(2)] + [cam.focal_mean * (cs[i] - cs[i - 1])[:2] / 2.0
                            for i in range(1, 12)]
    np.testing.assert_allclose(np.stack(torture.image_velocities(cam, poses)), np.stack(want),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("vel", [(3.0, 1.0), (-2.2, 6.5), (1.6, 0.0)])
def test_filters_match_opencv(vel):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (120, 160)).astype(np.float32)
    kern = torture.motion_kernel(vel)
    np.testing.assert_allclose(torture.filter2d(img, kern), cv2.filter2D(img, -1, kern),
                               rtol=0, atol=1e-3)
    tex = rng.integers(10, 90, (90, 110)).astype(np.float32)
    np.testing.assert_allclose(torture.gaussian_blur(tex, 1.5),
                               cv2.GaussianBlur(tex, (0, 0), 1.5), rtol=0, atol=1e-4)


# ---------------------------------------------------------------- photo curve
def test_photo_curve_chain_matches_the_jax_script(scripts):
    ps = scripts["make_photo_curve_artifact"]
    pc = make_photo_curve_artifact
    np.testing.assert_array_equal(pc.C_GT, ps.C_GT)
    np.testing.assert_array_equal(pc.V_GT, ps.V_GT)
    x = np.linspace(1e-3, 1.0, 777)
    np.testing.assert_allclose(pc.log_u_gt(x), np.asarray(ps.log_u_gt(x)), rtol=0, atol=1e-5)
    lut, lut_ref = pc.response_lut(), np.asarray(ps.response_lut())
    np.testing.assert_allclose(lut, lut_ref, rtol=0, atol=2e-3)
    # the corruption of main(): the exposure walk of seed 7, the vignette, the LUT
    cam, n = bench_camera(), 48
    rng = np.random.default_rng(7)
    log_e = np.cumsum(rng.uniform(-0.05, 0.05, n))
    for k in rng.integers(40, n - 1, max(2, n // 60)):
        log_e[k:] += rng.uniform(-0.2, 0.2)
    log_e = np.clip(log_e - log_e[0], -0.45, 0.45)
    np.testing.assert_array_equal(pc.exposure_walk(n, np.random.default_rng(7)), log_e)
    yy, xx = np.mgrid[0:cam.height, 0:cam.width]
    r2max = max((0 - cam.cx) ** 2 + (0 - cam.cy) ** 2,
                (cam.width - 1 - cam.cx) ** 2 + (cam.height - 1 - cam.cy) ** 2)
    r2n = ((xx - cam.cx) ** 2 + (yy - cam.cy) ** 2) / r2max
    vig = np.exp(jax_vig_basis(np.asarray(r2n, np.float32)) @ ps.V_GT)
    frames = clean_frames(cam, 3)
    got = pc.corrupt(cam, frames, log_e)
    for k, img in enumerate(frames):
        L = np.clip(1.7 * (img.astype(np.float32) - 120.0) + 120.0, 2.0, 253.0)
        y = np.clip(np.exp(log_e[k]) * vig * L, 0.0, 255.0)
        want = lut_ref[np.round(y).astype(np.int64)].astype(np.uint8)
        d = np.abs(got[k].astype(int) - want.astype(int))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (k, d.max(), (d > 0).mean())


@pytest.mark.parametrize("which", ["applied", "final", "identity"])
def test_curve_errors_are_the_scripts(scripts, which):
    """The recovery errors of the reference's ``curve_errs`` (a closure of its
    main, written out here with its own functions) for the estimates of its
    artifact and for the identity."""
    ps = scripts["make_photo_curve_artifact"]
    with open(os.path.join(ROOT, "artifacts", "photo_curve_recovery.json")) as fh:
        rec = json.load(fh)["curve_recovery"]
    c_est, v_est = {"applied": (rec["applied_smoothed"]["c_est"],
                                rec["applied_smoothed"]["v_est"]),
                    "final": (rec["final_window_solve"]["c_est"],
                              rec["final_window_solve"]["v_est"]),
                    "identity": ([0.0] * 4, [0.0] * 3)}[which]
    x = np.linspace(5.0 / 255.0, 250.0 / 255.0, 200)
    u_est = np.exp(np.log(x * 255.0) + jax_resp_basis(np.asarray(x, np.float32))
                   @ np.asarray(c_est, np.float32))
    u_gt = np.exp(ps.log_u_gt(x))
    R = np.linspace(0, 1, 100)
    vg_est = np.exp(jax_vig_basis(np.asarray(R, np.float32)) @ np.asarray(v_est, np.float32))
    vg_gt = np.exp(jax_vig_basis(np.asarray(R, np.float32)) @ ps.V_GT)
    want = {
        "inverse_response_rmse_frac": float(np.sqrt(np.mean(((u_est - u_gt) / 255.0) ** 2))),
        "inverse_response_max_frac": float(np.max(np.abs(u_est - u_gt) / 255.0)),
        "identity_response_rmse_frac": float(np.sqrt(np.mean(((x * 255.0 - u_gt) / 255.0)
                                                             ** 2))),
        "vignette_rmse": float(np.sqrt(np.mean((vg_est - vg_gt) ** 2))),
        "identity_vignette_rmse": float(np.sqrt(np.mean((1.0 - vg_gt) ** 2))),
    }
    got = make_photo_curve_artifact.curve_errs(c_est, v_est)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-6, err_msg=k)
    if which == "applied":
        # the reference's figures (its coefficients are stored to 4 decimals,
        # which moves the errors by up to ≈ 3e-5)
        for k in want:
            assert abs(got[k] - rec["applied_smoothed"][k]) <= 1e-4, k
    if which == "identity":
        assert got["inverse_response_rmse_frac"] == pytest.approx(
            got["identity_response_rmse_frac"], rel=1e-12)


# ---------------------------------------------------------------- patch source
def test_pendulum_trajectory_is_the_scripts(scripts):
    for a, b in zip(ab_patch_source.pendulum_trajectory(300),
                    scripts["ab_patch_source"].pendulum_trajectory(300)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- evaluate_ate
def _trajectory_pair(tmp_path):
    rng = np.random.default_rng(3)
    n = 60
    stamps = np.arange(n) * 0.05 + 100.0
    xyz = np.cumsum(rng.normal(0, 0.05, (n, 3)), axis=0)
    est = tmp_path / "est.txt"
    with open(est, "w") as fh:
        for s, p in zip(stamps[::2], 1.7 * xyz[::2] + rng.normal(0, 0.01, (n // 2, 3))):
            fh.write(f"{s:.6f} {p[0]:.9f} {p[1]:.9f} {p[2]:.9f} 0 0 0 1\n")
    gt = tmp_path / "gt.csv"
    with open(gt, "w") as fh:
        fh.write("#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z\n")
        for s, p in zip(stamps + 0.004, xyz):
            fh.write(f"{int(round(s * 1e9))},{p[0]:.9f},{p[1]:.9f},{p[2]:.9f},1,0,0,0\n")
    return str(est), str(gt)


@pytest.mark.parametrize("flags", [[], ["--no-scale"]], ids=["sim3", "se3"])
def test_evaluate_ate_matches_the_jax_script(scripts, tmp_path, monkeypatch, capsys, flags):
    est, gt = _trajectory_pair(tmp_path)
    assert evaluate_ate.main([est, gt, "--json", *flags]) == 0
    ours = json.loads(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["evaluate_ate.py", est, gt, "--json", *flags])
    assert scripts["evaluate_ate"].main() == 0
    ref = json.loads(capsys.readouterr().out)
    assert ours.keys() == ref.keys() and ours["n_pairs"] == ref["n_pairs"] == 30
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-12, atol=1e-12, err_msg=k)
    # too few pairs: both refuse
    assert evaluate_ate.main([est, gt, "--max-dt", "1e-6"]) == 2


# ---------------------------------------------------------------- visualize
def test_visualize_writes_png_and_ply(scripts, tmp_path, capsys):
    out = str(tmp_path / "map")
    assert visualize.main([f"checkpoint={BOOT_NPZ}", f"out={out}"]) == 0
    pts, inten, centers = visualize.load_checkpoint(BOOT_NPZ)
    ref = scripts["visualize"]._load_checkpoint(BOOT_NPZ)
    np.testing.assert_allclose(pts, ref[0], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(inten, ref[1])
    np.testing.assert_allclose(centers, ref[2], rtol=0, atol=1e-12)
    png = read_png(out + ".png")
    assert png.shape == (visualize.PANEL, 2 * visualize.PANEL, 3)
    assert (png != 255).any(axis=-1).sum() > len(pts)        # points, trajectory, text
    # keyframe centres are blue in both panels
    assert (png == np.array(visualize.BLUE, np.uint8)).all(axis=-1).sum() >= 2 * len(centers)
    with open(out + ".ply") as fh:
        lines = fh.read().splitlines()
    n = len(pts) + len(centers)
    assert f"element vertex {n}" in lines and len(lines) == lines.index("end_header") + 1 + n
    assert len(pts) == 483 and len(centers) == 6
    # a trajectory file alone: the PNG, no PLY
    traj = tmp_path / "traj.txt"
    np.savetxt(traj, np.c_[np.arange(5.0), np.cumsum(np.ones((5, 3)), 0), np.zeros((5, 3)),
                           np.ones(5)])
    assert visualize.main([f"traj={traj}", f"out={tmp_path / 't'}"]) == 0
    assert os.path.exists(tmp_path / "t.png") and not os.path.exists(tmp_path / "t.ply")
    assert visualize.main([]) == 1


# ---------------------------------------------------------------- batch tools
def test_single_sequence_runs_the_runner(tmp_path):
    data = tmp_path / "box"
    gen.write_dataset(str(data), n=6)
    res = subprocess.run(
        ["bash", os.path.join(ROOT, "hso_tpu_torch", "tools", "single_sequence.sh"),
         f"image={data}/images", f"calib={data}/calib.txt", f"times={data}/times.txt",
         "cpu=1", "name=box6", "no_native=1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-2000:]
    done = next(line for line in res.stdout.splitlines() if line.startswith("done: "))
    assert done.startswith("done: 6 frames") and done.endswith(", 0 failures")
    # the keyframe file holds the keyframes the runner counted (none yet:
    # the box sequence's bootstrap ends at frame 9)
    stamps, _ = load_tum(str(tmp_path / "result" / "box6.txt"))
    assert f"{len(stamps)} keyframes -> result/box6.txt" in done


@pytest.mark.parametrize("name", ["euroc_batch.sh", "icl_nuim_batch.sh", "tum_monovo_batch.sh"])
def test_batch_tools_name_the_reference_sequences(name):
    """The batch tools run the JAX scripts' sequences, skips and calibrations
    through the port's runner; without DATASET_PATH they refuse."""
    with open(os.path.join(ROOT, "hso_tpu_torch", "tools", name)) as fh:
        ours = fh.read()
    with open(os.path.join(ROOT, "scripts", name)) as fh:
        ref = fh.read()
    assert "python -m hso_tpu_torch.run_dataset" in ours and "run_dataset.py" not in ours
    for line in ref.splitlines():
        if line.startswith("#"):
            continue
        if line.startswith("run_seq ") or line.startswith("for name in ") \
                or "cameras/" in line or "photo=1" in line:
            key = line.split("$HERE/../")[-1].strip()
            assert key in ours, (name, key)
    res = subprocess.run(["bash", os.path.join(ROOT, "hso_tpu_torch", "tools", name)],
                         capture_output=True, text=True, timeout=60,
                         env={k: v for k, v in os.environ.items() if k != "DATASET_PATH"})
    assert res.returncode != 0 and "DATASET_PATH" in res.stderr

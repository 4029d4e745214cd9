"""Photometric calibration's deliverable: the recovered response and vignette.

The port's counterpart of the JAX package's
``scripts/make_photo_curve_artifact.py`` (the protocol of Bergmann, Wang and
Cremers, RA-L 2018).  Every rendered box frame, taken as the radiance L, is
observed as O = f(e_j · V(r) · L) with f = U⁻¹ for a ground-truth inverse
response inside the estimator's own basis (the ridge fit of an inverse gamma
0.6: strongly non-linear yet admissible), a polynomial vignette (corner ≈
0.65) and an exposure walk with steps (±0.45 in log), seed 7.  The sequence
runs through ``FrameHandler.add_image`` with calibration off and on
(``solve_every = min_frames = 8``); the artifact records both runs' ATE and,
for the run with calibration, the recovered curves' errors: inverse-response
RMSE as a fraction of full scale (over the usable range and over the
sampled intensities), vignette RMSE, both beside the identity's, and the
correlation of the final window's exposures with the truth; the reference's
figures (``artifacts/photo_curve_recovery.json``) beside them and the card's
name and power limit.

    python -m hso_tpu_torch.tools.make_photo_curve_artifact [n=400]
        [out=artifacts/photo_curve_recovery_torch.json] [cpu=1]
"""

from __future__ import annotations

import datetime
import json
import os
import sys

import numpy as np
import torch

from hso_tpu_torch.bench import ATE_GATE_M, ROOT, bench_camera, bench_scene, render_frames, \
    trajectory
from hso_tpu_torch.config import Config
from hso_tpu_torch.photometric.online_calib import _resp_basis, _vig_basis
from hso_tpu_torch.pipeline.scan import pin_float32_matmul
from hso_tpu_torch.tools.make_hard_artifact import (beside, device_of, hardware,
                                                    load_reference, run_handler)

#: ground-truth inverse response coefficients (basis x^k (1-x), k = 1..4): the
#: ridge fit of an inverse-gamma-0.6 curve inside the basis span
C_GT = np.array([-2.097, -0.002, 0.269, 0.258], np.float32)
#: ground-truth log-vignette polynomial in R = r²/r²max: corner ≈ 0.65
V_GT = np.array([-0.35, -0.05, -0.03], np.float32)
SEED = 7


def resp_basis(x) -> np.ndarray:
    """The calibrator's response basis φ_k(x) = x^k (1 - x) at x, float32."""
    return _resp_basis(torch.from_numpy(np.asarray(x, np.float32))).numpy()


def vig_basis(r2) -> np.ndarray:
    """The calibrator's vignette basis R^m at R = r2, float32."""
    return _vig_basis(torch.from_numpy(np.asarray(r2, np.float32))).numpy()


def log_u_gt(x):
    """log U(255·x) of the ground truth for x in (0, 1]."""
    return np.log(np.maximum(x, 1e-6) * 255.0) + resp_basis(x) @ C_GT


def response_lut() -> np.ndarray:
    """f = U⁻¹ as a 0..255 → 0..255 lookup (O = f(y): the smallest O with
    U(O) ≥ y)."""
    o_grid = np.linspace(1e-3, 1.0, 4096)
    u_vals = np.exp(log_u_gt(o_grid))
    o_of_y = np.interp(np.arange(256, dtype=np.float64), u_vals, o_grid * 255.0)
    return o_of_y.astype(np.float32)


def exposure_walk(n: int, rng) -> np.ndarray:
    """log exposure of each frame: a walk with steps, clipped to ±0.45."""
    log_e = np.cumsum(rng.uniform(-0.05, 0.05, n))
    for k in rng.integers(40, n - 1, max(2, n // 60)):
        log_e[k:] += rng.uniform(-0.2, 0.2)
    return np.clip(log_e - log_e[0], -0.45, 0.45)


def corrupt(cam, clean, log_e) -> list:
    """The observed frames O = f(e · V · L) of the clean renders, the radiance
    widened around grey 120 (the box textures are mid-heavy, a response is
    identifiable only where samples exist)."""
    yy, xx = np.mgrid[0:cam.height, 0:cam.width]
    r2max = max((0 - cam.cx) ** 2 + (0 - cam.cy) ** 2,
                (cam.width - 1 - cam.cx) ** 2 + (cam.height - 1 - cam.cy) ** 2)
    r2n = ((xx - cam.cx) ** 2 + (yy - cam.cy) ** 2) / r2max
    vig = np.exp(vig_basis(r2n) @ V_GT)
    lut = response_lut()
    frames = []
    for k, img in enumerate(clean):
        L = np.clip(1.7 * (img.astype(np.float32) - 120.0) + 120.0, 2.0, 253.0)
        y = np.clip(np.exp(log_e[k]) * vig * L, 0.0, 255.0)
        frames.append(lut[np.round(y).astype(np.int64)].astype(np.uint8))
    return frames


def curve_errs(c_est, v_est, lo: float = 5.0, hi: float = 250.0) -> dict:
    """Errors of an estimated inverse response and vignette against the truth:
    RMSE and max of U as a fraction of full scale over [lo, hi] grey levels,
    the identity's RMSE, the vignette's RMSE over R in [0, 1] and the
    identity's (as the reference reports them)."""
    x = np.linspace(lo / 255.0, hi / 255.0, 200)
    u_est = np.exp(np.log(x * 255.0) + resp_basis(x) @ np.asarray(c_est, np.float32))
    u_gt = np.exp(log_u_gt(x))
    R = np.linspace(0, 1, 100)
    vg_est = np.exp(vig_basis(R) @ np.asarray(v_est, np.float32))
    vg_gt = np.exp(vig_basis(R) @ V_GT)
    return {
        "inverse_response_rmse_frac": float(np.sqrt(np.mean(((u_est - u_gt) / 255.0) ** 2))),
        "inverse_response_max_frac": float(np.max(np.abs(u_est - u_gt) / 255.0)),
        "identity_response_rmse_frac": float(np.sqrt(np.mean(((x * 255.0 - u_gt) / 255.0)
                                                             ** 2))),
        "vignette_rmse": float(np.sqrt(np.mean((vg_est - vg_gt) ** 2))),
        "identity_vignette_rmse": float(np.sqrt(np.mean((1.0 - vg_gt) ** 2))),
        "c_est": [float(v) for v in np.asarray(c_est)],
        "v_est": [float(v) for v in np.asarray(v_est)],
    }


def curve_errs_coverage(c_est, v_est, lo_p: float, hi_p: float) -> dict:
    """:func:`curve_errs` plus the response errors over the sampled
    intensities' 5th–95th percentile range only."""
    d = curve_errs(c_est, v_est)
    cov = curve_errs(c_est, v_est, max(lo_p, 5.0), min(hi_p, 250.0))
    d["inverse_response_rmse_frac_coverage"] = cov["inverse_response_rmse_frac"]
    d["identity_rmse_frac_coverage"] = cov["identity_response_rmse_frac"]
    return d


def basis_capacity() -> float:
    """How well the basis itself expresses a gamma-0.6 camera (the bound an
    out-of-class response cannot beat)."""
    x = np.linspace(5.0 / 255.0, 250.0 / 255.0, 200)
    target = np.log(255.0) + np.log(x) / 0.6
    A = resp_basis(x).astype(np.float64)
    c_fit, *_ = np.linalg.lstsq(A, target - np.log(x * 255.0), rcond=None)
    return float(np.sqrt(np.mean(((np.exp(np.log(x * 255.0) + A @ c_fit) - np.exp(target))
                                  / 255.0) ** 2)))


def recovery(vo, log_e, n: int) -> dict:
    """The calibrated run's curve errors: the applied (smoothed) estimate and
    the final window's own solve, with the exposure correlation."""
    assert vo.photo.calibrated, "the calibrator never adopted a solution"
    samples = np.concatenate([fr["inten"] for fr in vo.photo.frames])
    lo_p, hi_p = (float(v) for v in np.percentile(samples, [5, 95]))
    curves = {"applied_smoothed": curve_errs_coverage(vo.photo.c, vo.photo.v, lo_p, hi_p),
              "sample_intensity_p5_p95": [lo_p, hi_p]}
    fin = vo.photo.solve()
    if fin is not None:
        curves["final_window_solve"] = curve_errs_coverage(fin["c"], fin["v"], lo_p, hi_p)
        le = np.asarray(fin["log_e"])
        gt_e = log_e[n - len(le):]
        curves["exposure_corr_final_window"] = float(np.corrcoef(
            le - le.mean(), gt_e - gt_e.mean())[0, 1])
    curves["c_gt"] = [float(v) for v in C_GT]
    curves["v_gt"] = [float(v) for v in V_GT]
    return curves


def main(argv=None) -> int:
    args = dict(a.split("=", 1) for a in (sys.argv[1:] if argv is None else argv) if "=" in a)
    device = device_of(args, "make_photo_curve_artifact")
    if device is None:
        return 2
    pin_float32_matmul()
    n = int(args.get("n", 400))
    out_path = args.get("out", os.path.join(ROOT, "artifacts",
                                            "photo_curve_recovery_torch.json"))
    ref = load_reference("photo_curve_recovery.json")

    cam = bench_camera()
    poses = trajectory(n)
    log_e = exposure_walk(n, np.random.default_rng(SEED))
    print(f"rendering and corrupting {n} frames ...", file=sys.stderr)
    frames = corrupt(cam, render_frames(bench_scene(cam), poses), log_e)

    results, curves = {}, {}
    for photo in (False, True):
        key = "photo_on" if photo else "photo_off"
        run = run_handler(cam, Config(photometric_calib=photo), frames, poses, device,
                          photo_every=8 if photo else 0)
        vo = run.pop("handler")
        run.pop("matches")
        run.pop("n_reloc_entries")
        results[key] = dict(run, **beside(run, ref.get(key) if ref else None))
        if photo:
            curves = recovery(vo, log_e, n)
        print(f"{key}: {results[key]}", file=sys.stderr)

    applied = curves["applied_smoothed"]
    ref_applied = ref["curve_recovery"]["applied_smoothed"] if ref else None
    doc = {
        "artifact": "photometric curve recovery (RA-L'18 protocol deliverable)",
        "protocol": "python -m hso_tpu_torch.tools.make_photo_curve_artifact; reference: "
                    "artifacts/photo_curve_recovery.json",
        "n_frames": n,
        "seed": SEED,
        "chain": "O = Uinv(e_j * V(r) * L); response in-basis (inverse-gamma-0.6 ridge fit, "
                 "log-log slope ratio 3.4), vignette corner 0.65, exposure walk +-0.45 log",
        "hardware": hardware(device),
        "date": datetime.date.today().isoformat(),
        **results,
        "curve_recovery": curves,
        "curve_recovery_beside_reference": beside(
            applied, ref_applied, keys=("inverse_response_rmse_frac", "vignette_rmse")),
        "basis_capacity_rmse_gamma06": basis_capacity(),
        "bars": {"n_failed_frames": 0, "ate_rmse_m_below": ATE_GATE_M,
                 "recovered_curves_beat_identity": True},
        "bars_met": (all(r["n_failed_frames"] == 0 and r["ate_rmse_m"] < ATE_GATE_M
                         for r in results.values())
                     and applied["inverse_response_rmse_frac"]
                     < applied["identity_response_rmse_frac"]
                     and applied["vignette_rmse"] < applied["identity_vignette_rmse"]),
    }
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as fh:
        json.dump(doc, fh, indent=1)
    print(json.dumps(doc, indent=1))
    return 0 if doc["bars_met"] else 1


if __name__ == "__main__":
    sys.exit(main())

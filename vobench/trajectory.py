"""Camera poses along the benchmark's sweep, from a traffic mix's parameters.

Frozen from ``hso_tpu_torch/bench.py::trajectory`` (the oscillating sweep
inside the box: twist components ``amp · sin(freq · t)``) and
``hso_tpu_torch/math/se3np.py::exp``.  The sweep runs in seconds, not frames:
``t = (frame / rate + phase) / seconds_per_unit``, so every camera flies the
same path at the same speed whatever its frame rate (at 0.6 s a unit the bench's
18 frames a unit at 30 Hz, 0.69 m/s on average).  Two parameters are the
benchmark's own: the start phase (seconds into the sweep, drawn from the
seed) and an amplitude schedule over frames (the hover mix shrinks the sweep
once the map is up, smoothly, so the pose stays continuous).
"""

from __future__ import annotations

import numpy as np


def _hat(w: np.ndarray) -> np.ndarray:
    return np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])


def se3_exp(xi: np.ndarray) -> np.ndarray:
    """(3, 4) float64 pose of the twist ``xi = (v, w)``."""
    v, w = np.asarray(xi[:3], np.float64), np.asarray(xi[3:], np.float64)
    th = float(np.linalg.norm(w))
    W = _hat(w)
    if th < 1e-10:
        R = np.eye(3) + W
        V = np.eye(3) + 0.5 * W
    else:
        a = np.sin(th) / th
        b = (1.0 - np.cos(th)) / th ** 2
        c = (1.0 - a) / th ** 2
        R = np.eye(3) + a * W + b * (W @ W)
        V = np.eye(3) + b * W + c * (W @ W)
    return np.concatenate([R, (V @ v)[:, None]], axis=1)


def amplitude(k: np.ndarray, schedule) -> np.ndarray:
    """Amplitude at frames ``k``: piecewise between the schedule's
    ``[frame, scale]`` knots with a cosine ease, constant outside."""
    knots = sorted((float(f), float(s)) for f, s in schedule)
    a = np.full(k.shape, knots[0][1])
    for (f0, s0), (f1, s1) in zip(knots, knots[1:]):
        x = np.clip((k - f0) / max(f1 - f0, 1e-9), 0.0, 1.0)
        e = 0.5 - 0.5 * np.cos(np.pi * x)
        a = np.where(k >= f0, s0 + (s1 - s0) * e, a)
    return a


def poses(n: int, motion: dict, phase_s: float, rate_hz: float) -> np.ndarray:
    """(n, 3, 4) world→camera poses of frames ``0..n-1`` taken at ``rate_hz``
    along the sweep started ``phase_s`` seconds in."""
    k = np.arange(n, dtype=np.float64)
    t = (k / float(rate_hz) + float(phase_s)) / float(motion["seconds_per_unit"])
    amp = amplitude(k, motion.get("amplitude", [[0, 1.0]]))
    comp = np.asarray(motion["components"], np.float64)          # (6, 2): amp, freq
    xi = amp[:, None] * comp[None, :, 0] * np.sin(comp[None, :, 1] * t[:, None])
    return np.stack([se3_exp(x) for x in xi])

"""TUM-format keyframe trajectory export (evo-compatible), one line a keyframe:

    <stamp> tx ty tz qx qy qz qw       (camera-to-world)
"""

from __future__ import annotations

import os

import numpy as np

from hso_tpu_torch.math import se3np


def rotation_to_quaternion(R: np.ndarray) -> np.ndarray:
    """(x, y, z, w) from a rotation matrix (Shepperd's method)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2.0
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2.0
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[3] = (R[k, j] - R[j, k]) / s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        x, y, z, w = q
    return np.array([x, y, z, w])


def save_keyframe_trajectory(handler, path: str) -> int:
    """Write every keyframe pose of ``handler`` (TUM format, camera-to-world);
    a keyframe's ``stamp_str``, where the runner set one, is its stamp.
    Returns the number of lines."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = 0
    with open(path, "w") as fh:
        for kf in handler.kfs.frames:
            T_w_c = se3np.inv(kf.T_f_w)
            t = se3np.translation(T_w_c)
            q = rotation_to_quaternion(se3np.rotation(T_w_c))
            stamp = getattr(kf, "stamp_str", None) or repr(kf.timestamp)
            fh.write(
                f"{stamp} {t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
                f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}\n"
            )
            n += 1
    return n

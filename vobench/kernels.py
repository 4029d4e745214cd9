"""The least time each of the port's six CUDA kernels (K1-K6) needs for one
launch, from the launch as a device trace records it (name, grid, block) and the configuration's shapes.

Frozen from ``chip_smoke.py`` (``bound``, ``PEAK_BYTES_PER_S``,
``PEAK_F32_FLOPS`` and the bytes and operations of ``hold_k1_calls`` ..
``hold_k6_calls``) and from the launch plans of ``hso_tpu_torch/csrc``
(``window.cu``: 8 windows a block up to win 32, 4 above; ``align.cu``: one warp
a candidate, ``win²`` floats of shared memory a warp; ``epipolar.cu``: 64
threads a seed).  The published peaks of one H100 SXM: 3.35 TB/s of HBM and
67 TFLOP/s of float32 outside the tensor cores (none of these kernels uses
them).

Rows are counted at the most the grid can hold; what depends on the data
(iterations, trials, rows with a window to read) at the least, so the bound
is never above what the launch had to do.
"""

from __future__ import annotations

import math
import re

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

#: the kernels by the name the trace gives them
KERNELS = (
    ("K1", re.compile(r"extract_windows_kernel<(\d+)>")),
    ("K2", re.compile(r"pack_level_windows_kernel<(\d+)>")),
    ("K3", re.compile(r"coarse_level_ic_kernel")),
    ("K4", re.compile(r"align_match_kernel")),
    ("K5", re.compile(r"pose_lm_kernel")),
    ("K6", re.compile(r"zmncc_line_kernel")),
)
K6_GROUP = 64          #: threads a seed
K3_PATTERN_MIN = 9     #: the smallest pattern of the coarse levels


def bound_s(bytes_moved: float, flops: float) -> float:
    return max(bytes_moved / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS)


def kernel_of(name: str):
    """(kernel id, regex match) of a trace kernel name, or None."""
    for kid, rx in KERNELS:
        m = rx.search(name)
        if m:
            return kid, m
    return None


def launch_bound_s(name: str, grid, block, n_features: int) -> float | None:
    """Seconds one launch needs at least, or None for a kernel of another
    program.  ``n_features``: the coarse tracker's feature count (the
    configuration's grid cells)."""
    hit = kernel_of(name)
    if hit is None:
        return None
    kid, m = hit
    blocks = int(math.prod(grid))
    threads = int(math.prod(block))
    if kid in ("K1", "K2"):
        win = int(m.group(1))
        rows = blocks * (8 if 0 < win <= 32 else 4)
        per_row = 2 * win * win * 4 + (2 if kid == "K1" else 3) * 4
        return bound_s(rows * per_row, 0)
    if kid == "K3":
        n, p = n_features, K3_PATTERN_MIN
        nbytes = n * 576 * 4 + n * p * 4 + n * p * 24 + n * 12 + n * 8 + n + 12 * 4 + 12 + 64
        return bound_s(nbytes, n * p * 100 + n * 30)
    if kid == "K4":
        warps = max(threads // 32, 1)
        s = blocks * warps
        return bound_s(s * (100 * 4 + 16 + 16 + 2) + 8 * s * 4, s * 64 * 40)
    if kid == "K5":
        n = threads
        return bound_s(n * 8 * 4 + 3 * n + 12 * 4 + 8 + 256, n * 190 + n * 40)
    # K6: the per-row inputs and outputs of every seed the grid holds
    s = blocks * max(threads // K6_GROUP, 1)
    return bound_s(s * 9 * 4 + s * 3 * 4, 0)

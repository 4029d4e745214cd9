"""Residual-pattern tables for direct alignment.

The coarse tracker samples a fixed constellation of pixels around each
feature instead of a dense square patch (DSO-style "residual patterns";
the port's own copy of the JAX package's table).
The pattern used at pyramid level L is ``PATTERNS[max_level - L + 2]`` —
finer levels get wider constellations.

Stored here as ragged Python lists of (dx, dy) offsets; :func:`pattern_arrays`
pads them to a static (P_MAX, 2) int array plus a validity count so kernels
stay static-shape.
"""

from __future__ import annotations

import numpy as np

# index 0: single centre pixel
_P_CENTER = [(0, 0)]

# index 1: 5-point "+"
_P_PLUS = [(0, -1), (-1, 0), (0, 0), (1, 0), (0, 1)]

# index 2: tight 3x3 block ("full-tight-9"; note the reference repeats (-1,0)
# and omits (0,-1) — we use the regular 3x3 which it plainly intends)
_P_9 = [(dx, dy) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]

# index 3: diamond-13 ("full-tight-13")
_P_13_TIGHT = [
    (0, -2), (-1, -1), (1, -1), (-2, 0), (0, 0), (2, 0), (-1, 1), (1, 1), (0, 2),
    (0, -1), (-1, 0), (1, 0), (0, 1),
]

# index 4: diamond-9 + 2px diagonals ("full-spread-13")
_P_13_SPREAD = [
    (0, -2), (-1, -1), (1, -1), (-2, 0), (0, 0), (2, 0), (-1, 1), (1, 1), (0, 2),
    (-2, -2), (-2, 2), (2, -2), (2, 2),
]

# index 5: spread-13 + 3px ring ("full-spread-21")
_P_21_SPREAD = _P_13_SPREAD + [
    (-3, -1), (-3, 1), (3, -1), (3, 1), (1, -3), (-1, -3), (1, 3), (-1, 3),
]

# index 6: dense 5x5 ("full-25")
_P_25 = [(dx, dy) for dx in (-2, -1, 0, 1, 2) for dy in (-2, -1, 0, 1, 2)]

# index 7: 5x5 at stride 2 ("full-45-SPREAD")
_P_25_SPREAD = [(dx, dy) for dx in (-4, -2, 0, 2, 4) for dy in (-4, -2, 0, 2, 4)]

PATTERNS = [
    _P_CENTER, _P_PLUS, _P_9, _P_13_TIGHT, _P_13_SPREAD, _P_21_SPREAD, _P_25, _P_25_SPREAD,
]

#: border padding needed around the pattern (CoarseTracker.h staticPatternPadding)
PATTERN_PADDING = [1, 1, 1, 2, 2, 3, 2, 4]

P_MAX = 25  # widest pattern size


def pattern_arrays(index: int) -> tuple[np.ndarray, int, int]:
    """Return (offsets (P_MAX, 2) int32 padded with zeros, n_valid, padding)."""
    pat = PATTERNS[index]
    out = np.zeros((P_MAX, 2), np.int32)
    out[: len(pat)] = np.asarray(pat, np.int32)
    return out, len(pat), PATTERN_PADDING[index]

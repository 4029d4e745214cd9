"""SE(3) on numpy (float64): host-side pose bookkeeping, synthetic scenes and
ground-truth trajectories.  Conventions: :mod:`hso_tpu_torch.math._se3_impl`.
"""

import numpy as np

from hso_tpu_torch.math._se3_impl import _make_se3

_ns = _make_se3(np, np.float64)

identity = _ns.identity
from_Rt = _ns.from_Rt
rotation = _ns.rotation
translation = _ns.translation
mul = _ns.mul
inv = _ns.inv
apply = _ns.apply
rotate = _ns.rotate
hat = _ns.hat
so3_exp = _ns.so3_exp
so3_log = _ns.so3_log
exp = _ns.exp
log = _ns.log
adjoint = _ns.adjoint
normalize = _ns.normalize

"""hso_tpu_torch — PyTorch/CUDA port of the hybrid sparse monocular VO.

The package sits beside the JAX package it was ported from and imports
nothing of it: plain tensor code is PyTorch, and every fused device kernel
is hand-written CUDA C++ under ``csrc/`` (built at first use, see
:mod:`hso_tpu_torch._cuda_build`).  Entry points take an explicit ``device``
argument (default ``"cuda"``); CPU tensors take each kernel's plain PyTorch
version.

Ported so far: the whole per-frame step
(:func:`hso_tpu_torch.pipeline.fused_step.make_frame_step`: tracking,
matching, pose refinement and the depth-filter seed sweep) and the seed
table's life on the device (:mod:`hso_tpu_torch.mapping.depth_filter`).
"""

__version__ = "0.1.0"

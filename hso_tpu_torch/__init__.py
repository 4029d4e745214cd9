"""hso_tpu_torch — PyTorch/CUDA port of the hybrid sparse monocular VO.

The package sits beside the JAX package it was ported from and imports
nothing of it: plain tensor code is PyTorch, and every fused device kernel
is hand-written CUDA C++ under ``csrc/`` (built at first use, see
:mod:`hso_tpu_torch._cuda_build`).  Entry points take an explicit ``device``
argument (default ``"cuda"``); CPU tensors take each kernel's plain PyTorch
version.

Ported so far: the whole per-frame step
(:func:`hso_tpu_torch.pipeline.fused_step.make_frame_step`: tracking,
matching, pose refinement and the depth-filter seed sweep), the seed table's
life on the device (:mod:`hso_tpu_torch.mapping.depth_filter`), and the
benchmark's evolving-map scan (:func:`hso_tpu_torch.pipeline.scan.run_scan`)
with its keyframe work: detection (:mod:`hso_tpu_torch.ops.detect`), the
windowed Schur BA (:mod:`hso_tpu_torch.ba.local_ba`), seed harvest and
activation (:mod:`hso_tpu_torch.pipeline.keyframe`); its entry point is
``python -m hso_tpu_torch.bench``.  And the host pipeline users call,
:class:`hso_tpu_torch.pipeline.frame_handler.FrameHandler` (``add_image``:
bootstrap, tracking with its keyframe events and BA, seed rescue,
relocalization, reset), with checkpoints
(:mod:`hso_tpu_torch.utils.checkpoint`), online photometric calibration
(:mod:`hso_tpu_torch.photometric`) and stage tracing
(:mod:`hso_tpu_torch.utils.trace`).  And the dataset path: calibration,
image and trajectory I/O (:mod:`hso_tpu_torch.io`, PNG without OpenCV, a
prefetching reader), the live viewer (:mod:`hso_tpu_torch.utils.live_view`)
and the runner ``python -m hso_tpu_torch.run_dataset``.  And the rest: the
lag-1 host loop (``FrameHandler.add_image_pipelined``/``flush``) and the
point-sharded BA over ``torch.distributed``
(:mod:`hso_tpu_torch.ba.distributed`).  Every module of the JAX package has
its counterpart here.  On the card the step runs as one device program
(:class:`hso_tpu_torch.pipeline.step_graph.StepGraph`: CUDA graphs whose
FC/IC choice and FC level LM are IF nodes), the counterpart of the JAX
step's ``jit``.
"""

__version__ = "0.1.0"

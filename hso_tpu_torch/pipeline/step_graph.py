"""The per-frame step as one device program: the step of
:func:`~hso_tpu_torch.pipeline.fused_step.make_frame_step` or
:func:`~hso_tpu_torch.pipeline.fused_step.make_track_step` captured in CUDA
graphs and replayed, a frame one graph launch.

Counterpart of the ``@jax.jit`` boundary of the JAX step
(``hso_tpu/pipeline/fused_step.py:99``), which has no module of its own in the
JAX package: there XLA compiles the step with its ``lax.cond`` and
``lax.while_loop`` into one program; here the step's FC/IC choice and the FC
level LM are IF nodes of the graph
(:mod:`hso_tpu_torch.utils.control_flow`), so a replay never waits for the
host and the host never waits for the device.

``StepGraph(step, device)`` is called as the step is.  At the first call it
builds the kernel library, runs the step once eagerly on a side stream with
both branches of every ``cond`` (everything set up lazily: the library, the
kernels' shared-memory opt-in, the pattern tables on the device), then
captures two instances of the graph, A and B, each with its own input
tensors, its own memory pools and its own outputs.

Each call stages its arguments into the input tensors of the next instance
and replays it; calls alternate between A and B.  Staging copies every tensor
in place (a replay reads the tensors the capture saw, so a snapshot or seed
table the caller replaced at a keyframe event is copied, never re-pointed),
fills a Python number into its 0-d float32 tensor and uploads a numpy array
through pinned memory without waiting.  The image is staged as float32 (the
pyramid's first step; the bits are the eager step's).  A source that is
itself an input tensor of the instance is copied aside first, so staging
never reads what it has already overwritten.

**The outputs are the instance's own tensors**, overwritten when that
instance runs again: the result of a call stays valid through the next call
and until the call after it.  That covers a scan's carry and the lag-1 loop's
pending frame; a caller that keeps a result longer copies it.

The class is generic over its callable: the scan's keyframe body
(:func:`hso_tpu_torch.pipeline.scan.make_keyframe_body`, the JAX bench's
``lax.cond`` around the keyframe work) and the handler's windowed-BA solve
(:func:`hso_tpu_torch.pipeline.ba_glue.captured_local_ba`, the JAX package's
``_jitted_local_ba``) are captured by it too.  ``image=False`` stages the first
argument as it comes (not as an image), and ``instances`` sets the number of
instances used in turns: a caller that reads each result before the next
call (the BA solve) needs one.

On the card a capture, instantiation or replay that fails raises; nothing
falls back to the eager step (the eager step is the step itself, not wrapped).
On a CPU device (tests) an instance's replay calls the step on its input
tensors and copies the results into its outputs, so the staging and the
alternation run where there is no card.
"""

from __future__ import annotations

import gc
import time
import weakref

import numpy as np
import torch

from hso_tpu_torch.utils import control_flow


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        for r in rest:
            if not isinstance(r, dict) or set(r) != set(tree):
                raise ValueError(f"step argument changed structure: keys {sorted(tree)} against "
                                 f"{sorted(r) if isinstance(r, dict) else type(r).__name__}")
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (tuple, list)):
        for r in rest:
            if not isinstance(r, (tuple, list)) or len(r) != len(tree):
                raise ValueError("step argument changed structure: a sequence changed length")
        return type(tree)(_tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _input_like(x, device, as_float32: bool = False) -> torch.Tensor:
    """The input tensor that stands for argument leaf ``x``."""
    if isinstance(x, torch.Tensor):
        shape, dtype = tuple(x.shape), x.dtype
    elif isinstance(x, np.ndarray):
        shape, dtype = x.shape, torch.from_numpy(np.ascontiguousarray(x[:0])).dtype
    elif isinstance(x, (float, int, np.floating, np.integer)) and not isinstance(x, bool):
        shape, dtype = (), torch.float32
    else:
        raise TypeError(f"a step argument of type {type(x).__name__} cannot be staged")
    return torch.empty(shape, dtype=torch.float32 if as_float32 else dtype, device=device)


def _stage_leaf(dst: torch.Tensor, src) -> None:
    if isinstance(src, torch.Tensor):
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"step argument changed shape: {tuple(dst.shape)} -> "
                             f"{tuple(src.shape)}")
        if src.dtype != dst.dtype and not (dst.dtype == torch.float32
                                           and src.dtype == torch.uint8):
            raise ValueError(f"step argument changed type: {dst.dtype} -> {src.dtype}")
        if src is not dst:
            dst.copy_(src)
    elif isinstance(src, np.ndarray):
        host = torch.from_numpy(np.ascontiguousarray(src))
        if dst.is_cuda:
            host = host.pin_memory().to(dst.device, non_blocking=True)
        _stage_leaf(dst, host)
    else:
        if dst.shape != ():
            raise ValueError(f"a number staged into a tensor of shape {tuple(dst.shape)}")
        dst.fill_(float(src))


def _release(graph, device_index: int, pool, routes: int) -> None:
    """When an instance goes: its graph, then the pool its IF bodies
    allocated from (each top-level body took one reference on it)."""
    graph.reset()
    release = getattr(torch._C, "_cuda_releasePool", None)
    if release is not None:
        for _ in range(routes):
            release(device_index, pool)


class _Instance:
    """One captured graph: its input tensors, its outputs, its IF-node scope
    (body streams and pool) and the graph itself."""

    def __init__(self, args, device, image: bool = True):
        self.device = device
        self.inputs = tuple(
            _tree_map(lambda x, head=(k == 0): _input_like(x, device, image and head), a)
            for k, a in enumerate(args))
        self._input_storages = {t.untyped_storage().data_ptr() for t in _leaves(self.inputs)}
        self.out = None
        self.nodes = None
        self.graph = None
        self.scope = None

    def stage(self, args) -> None:
        if len(args) != len(self.inputs):
            raise ValueError(f"the step takes {len(self.inputs)} arguments, got {len(args)}")

        def aside(x):
            # a source inside this instance's inputs is read before any is written
            if isinstance(x, torch.Tensor) and x.untyped_storage().data_ptr() in \
                    self._input_storages:
                return x.clone()
            return x

        srcs = [_tree_map(aside, a) for a in args]
        for dst, src in zip(self.inputs, srcs):
            _tree_map(_stage_leaf, dst, src)

    def capture(self, step) -> None:
        self.graph = torch.cuda.CUDAGraph()
        self.scope = control_flow.IfNodeScope(self.device)
        with control_flow.if_node_scope(self.scope), \
                torch.cuda.graph(self.graph, stream=self.scope.capture_stream):
            out = step(*self.inputs)
            # a graph without IF nodes is counted whole, else its leaf IF bodies
            self.nodes = (control_flow.capture_counts(self.scope) if not self.scope.routes
                          else (self.scope.leaf_nodes, self.scope.leaf_kernels))
        weakref.finalize(self, _release, self.graph, self.device.index, self.scope.pool,
                         self.scope.routes).atexit = False
        for t in _leaves(out):
            if not (isinstance(t, torch.Tensor) and t.is_cuda):
                raise TypeError(f"a captured step returned a {type(t).__name__} that a "
                                f"replay could not update")
        self.out = out

    def run(self, step):
        if self.graph is not None:
            self.graph.replay()
            return self.out
        res = step(*self.inputs)            # CPU: the body called directly
        if self.out is None:
            self.out = _tree_map(lambda t: t.clone(), res)
        else:
            _tree_map(lambda o, r: o.copy_(r), self.out, res)
        return self.out


class StepGraph:
    """A frame step captured as two alternating CUDA graphs (see the module
    docstring); called with the step's arguments, returns its output dict.
    ``instances``: graphs used in turns (a result lives through
    ``instances - 1`` further calls); ``image``: the first argument is an
    image, staged as float32."""

    def __init__(self, step, device="cuda", instances: int = 2, image: bool = True):
        if instances < 1:
            raise ValueError(f"a StepGraph needs at least one instance, not {instances}")
        self.step = step
        self.n_instances = int(instances)
        self.image = bool(image)
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._instances = None
        self._turn = 0
        #: seconds of the warm-up and of the captures; bytes the captures
        #: added to the device memory reserved; (nodes, kernel nodes) of one
        #: instance: of its whole graph when it holds no IF node, else of its
        #: IF bodies that hold none (every iteration of a gated loop counted)
        self.warm_up_seconds = None
        self.capture_seconds = None
        self.pool_bytes = None
        self.nodes = None

    def warm_up(self, *args) -> None:
        """Build the kernels and run the step once eagerly with both branches
        of every ``cond`` (on a side stream), from ``args``."""
        from hso_tpu_torch import _cuda_build

        t0 = time.perf_counter()
        _cuda_build.lib()
        inst = _Instance(args, self.device, self.image)
        inst.stage(args)
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side), control_flow.warm_both_branches():
            self.step(*inst.inputs)
        cur.wait_stream(side)
        torch.cuda.synchronize(self.device)
        self.warm_up_seconds = time.perf_counter() - t0

    def capture(self, *args) -> None:
        """Warm up (on the card, unless done) and capture the instances from
        the shapes of ``args``."""
        if self.device.type != "cuda":
            self._instances = [_Instance(args, self.device, self.image)
                               for _ in range(self.n_instances)]
            return
        if self.warm_up_seconds is None:
            self.warm_up(*args)
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        instances = [_Instance(args, self.device, self.image) for _ in range(self.n_instances)]
        # no garbage collection while capturing: an old handler's graph freed
        # then would call the CUDA runtime in the middle of the capture
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            for inst in instances:
                inst.stage(args)
                inst.capture(self.step)
                inst.graph.replay()  # instantiated and run once before the first timed call
        finally:
            if collecting:
                gc.enable()
        torch.cuda.synchronize(self.device)
        self.capture_seconds = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.nodes = instances[0].nodes
        self._instances = instances

    @property
    def captured(self) -> bool:
        return self._instances is not None

    def stage(self, *args) -> _Instance:
        """Capture at the first call, then copy ``args`` into the next
        instance's inputs: the host's part of a call."""
        if self._instances is None:
            self.capture(*args)
        inst = self._instances[self._turn]
        self._turn = (self._turn + 1) % len(self._instances)
        inst.stage(args)
        return inst

    def run(self, inst: _Instance):
        """Replay a staged instance: its output dict."""
        return inst.run(self.step)

    def __call__(self, *args):
        return self.run(self.stage(*args))

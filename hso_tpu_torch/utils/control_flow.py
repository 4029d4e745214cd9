"""Branches and bounded loops on device values: the port's counterparts of
``jax.lax.cond`` and of ``jax.lax.while_loop`` with a trip bound.

The JAX step is one compiled program: its FC/IC choice is a ``lax.cond``
(``hso_tpu/pipeline/fused_step.py:115-119``) and the FC tracker's level LM a
``lax.while_loop`` (``hso_tpu/track/coarse_tracker.py:260-290``).  The port's
step is eager PyTorch, and on the card :mod:`hso_tpu_torch.pipeline.step_graph`
captures it into a CUDA graph.  Every branch on a device value of the step
goes through :func:`cond` or :func:`gated_loop`:

- on a CPU tensor, and on the card outside a capture (the eager step), the
  host reads the predicate through :func:`read_flag`, the one function that
  does, and runs what it names (on the card that read waits for the device);
- under capture each branch, and each iteration of the loop, becomes an IF
  node of the graph (``csrc/graph_cond.cu``: the PyTorch build the port runs
  on has no conditional-node API): the graph reads the predicate at replay and
  a body whose predicate is false launches nothing.  Both branches are
  captured, so they write one set of output tensors: the false branch's
  results are copied into the true branch's.  An IF node needs the scope
  :class:`IfNodeScope` that the capture opens (:func:`if_node_scope`): the
  streams its bodies are captured on and the memory pool they allocate from.

:func:`warm_both_branches` makes :func:`cond` run both branches eagerly (the
warm-up before a capture: every lazy set-up of either branch happens there,
not in the capture).
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes

import torch

#: the IF-node scope of the capture under way (None outside a capture)
_SCOPE = contextvars.ContextVar("hso_if_node_scope", default=None)
#: True while the warm-up before a capture runs both branches of every cond
_WARM = contextvars.ContextVar("hso_warm_both_branches", default=False)
#: nesting depth an IF-node scope supports (FC branch → loop iteration)
MAX_DEPTH = 4


def read_flag(flag: torch.Tensor) -> bool:
    """The host's reading of a device predicate: the one place where the
    step's control flow reads a tensor on the host.  Never reached under
    capture (the predicate becomes an IF node)."""
    return bool(flag)


def _capturing(t: torch.Tensor) -> bool:
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


class IfNodeScope:
    """What the IF nodes of one capture need: the stream the capture runs on
    and a stream for the bodies of each nesting depth, taken together so that
    no body is ever captured on the capturing stream (PyTorch hands its pooled
    streams out in turn, so a stream taken at another time may be that one),
    and a memory pool, apart from the graph's own, that every allocation
    inside a body comes from (allocations of this thread are sent there while
    a top-level body is captured).  The pool's blocks are the graph's: it
    reads and writes them at every replay."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.capture_stream = torch.cuda.Stream(self.device)
        self.streams = [torch.cuda.Stream(self.device) for _ in range(MAX_DEPTH)]
        self.pool = torch.cuda.graph_pool_handle()
        #: top-level bodies captured (each took one reference on the pool)
        self.routes = 0
        self._has_child = []
        #: nodes and kernel nodes of the bodies that hold no IF node
        self.leaf_nodes = 0
        self.leaf_kernels = 0


@contextlib.contextmanager
def if_node_scope(scope: IfNodeScope):
    """Let :func:`cond` and :func:`gated_loop` make IF nodes in the capture
    this block runs."""
    token = _SCOPE.set(scope)
    try:
        yield scope
    finally:
        _SCOPE.reset(token)


@contextlib.contextmanager
def warm_both_branches():
    """Run both branches of every :func:`cond` eagerly (the true branch's
    result is returned)."""
    token = _WARM.set(True)
    try:
        yield
    finally:
        _WARM.reset(token)


@contextlib.contextmanager
def _if_node(pred: torch.Tensor, negate: bool):
    """Capture the block into the body of an IF node on ``pred`` (on its
    negation with ``negate``) of the graph being captured."""
    from hso_tpu_torch import _cuda_build

    scope = _SCOPE.get()
    if scope is None:
        raise RuntimeError("a device branch under CUDA-graph capture needs an IfNodeScope "
                           "(hso_tpu_torch.pipeline.step_graph.StepGraph opens one)")
    if pred.dtype != torch.bool or pred.numel() != 1:
        raise ValueError(f"an IF node reads one bool, got {pred.dtype} {tuple(pred.shape)}")
    depth = len(scope._has_child)
    if depth >= MAX_DEPTH:
        raise RuntimeError(f"IF nodes nested deeper than {MAX_DEPTH}")
    if depth:
        scope._has_child[-1] = True
    lib = _cuda_build.lib()
    dev = pred.device.index if pred.device.index is not None else torch.cuda.current_device()
    parent = torch.cuda.current_stream(pred.device)
    stream = scope.streams[depth]
    _cuda_build.check(lib.hso_if_node_begin(parent.cuda_stream, pred.data_ptr(), int(negate),
                                            stream.cuda_stream), "hso_if_node_begin")
    scope._has_child.append(False)
    try:
        with torch.cuda.stream(stream):
            if depth == 0:
                torch._C._cuda_beginAllocateCurrentThreadToPool(dev, scope.pool)
                scope.routes += 1
            try:
                yield
            finally:
                if depth == 0:
                    torch._C._cuda_endAllocateToPool(dev, scope.pool)
    finally:
        leaf = not scope._has_child.pop()
        nodes, kernels = ctypes.c_longlong(0), ctypes.c_longlong(0)
        counts = (ctypes.byref(nodes), ctypes.byref(kernels)) if leaf else (None, None)
        _cuda_build.check(lib.hso_if_node_end(stream.cuda_stream, *counts), "hso_if_node_end")
        scope.leaf_nodes += nodes.value
        scope.leaf_kernels += kernels.value


def capture_counts(scope: IfNodeScope) -> tuple:
    """(nodes, kernel nodes) of the graph being captured on the scope's
    capture stream, which must hold no IF node (counting one that does
    fails on the card)."""
    from hso_tpu_torch import _cuda_build

    nodes, kernels = ctypes.c_longlong(0), ctypes.c_longlong(0)
    _cuda_build.check(_cuda_build.lib().hso_capture_counts(
        scope.capture_stream.cuda_stream, ctypes.byref(nodes), ctypes.byref(kernels)),
        "hso_capture_counts")
    return nodes.value, kernels.value


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    raise TypeError(f"cond takes and returns trees of tensors, not a {type(tree).__name__}")


def cond(pred: torch.Tensor, true_fn, false_fn, operands: tuple = ()):
    """``true_fn(*operands)`` where the device bool ``pred`` holds, else
    ``false_fn(*operands)``; the two return trees of tensors of the same
    shapes and types (``jax.lax.cond``).  Under capture: two IF nodes, on
    ``pred`` and on its negation, never both branches run and selected."""
    if _WARM.get():
        out = true_fn(*operands)
        false_fn(*operands)
        return out
    if not _capturing(pred):
        return true_fn(*operands) if read_flag(pred) else false_fn(*operands)
    inputs = {t.untyped_storage().data_ptr() for t in _leaves(operands)}
    with _if_node(pred, negate=False):
        out = true_fn(*operands)
        # an output that is an operand would be overwritten by the false branch
        out_leaves = [t.clone() if t.untyped_storage().data_ptr() in inputs else t
                      for t in _leaves(out)]
    with _if_node(pred, negate=True):
        alt = _leaves(false_fn(*operands))
        if len(alt) != len(out_leaves):
            raise ValueError("the branches of cond return trees of different sizes")
        for o, a in zip(out_leaves, alt):
            if o.shape != a.shape or o.dtype != a.dtype:
                raise ValueError(f"cond branches differ: {o.dtype} {tuple(o.shape)} against "
                                 f"{a.dtype} {tuple(a.shape)}")
            o.copy_(a)
    return _rebuild(out, iter(out_leaves))


def _rebuild(tree, it):
    if isinstance(tree, torch.Tensor):
        return next(it)
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in tree}
    return type(tree)(_rebuild(v, it) for v in tree)


def gated_loop(n_iter: int, active: torch.Tensor, body) -> None:
    """At most ``n_iter`` calls of ``body()`` while the device bool ``active``
    holds (``jax.lax.while_loop`` whose condition bounds the trip count):
    ``body`` updates its state in place and sets ``active`` for the next
    iteration.  On the host's reading the loop ends at the first false
    ``active``; under capture each iteration is an IF node on ``active``, so
    after the stop the remaining iterations launch nothing."""
    for _ in range(n_iter):
        if _capturing(active):
            with _if_node(active, negate=False):
                body()
        elif read_flag(active):
            body()
        else:
            return

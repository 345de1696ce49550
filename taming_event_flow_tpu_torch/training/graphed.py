"""CUDA graphs of the training step's device work.

On the card, :func:`.step.make_train_step` replays a window's unpack, its
P passes, the loss and ``loss.backward()`` as one ``torch.cuda.CUDAGraph``
instead of dispatching them kernel by kernel (most of that dispatch is
autograd's backward, and an eager step leaves the card idle while the host
catches up). The optimizer (the clip pre-hook and the update) stays eager
after the replay, reading the gradients the graph wrote.

The policy (:class:`StepGraphs`), keyed by what the step observes in its
input (:func:`signature`: the window's keys, shapes and dtypes, the carry's
shapes, the float32 precision settings):

  * the first call of a signature runs eagerly: it is the warm-up, and a
    real step;
  * the second captures the work once, then replays it at once to execute
    that same step; every later call replays;
  * a step keeps the first ``MAX_GRAPHS`` signatures it meets, warmed up
    or captured, and drops none: a signature past them runs eagerly on
    every call. So a run captures at most ``MAX_GRAPHS`` times, whatever
    order its window shapes come in, and a graph in use is never dropped
    for a shape that comes once. The training CLI pads a window to a
    power-of-two bucket (``data.base.bucket_size``), so its windows take
    a few signatures, one a bucket its traffic reaches.

The graphs of a step share one memory pool. No two replay at once, each
keeps its input buffers outside the pool and its outputs alive, and a
replay reads nothing of the pool that it did not write itself: so one
graph's intermediates may take another's dead ones, and the step's graphs
hold about the memory of its largest plus their gradients.

A replay copies the window and the carry into the graph's input buffers,
replays, and hands back clones of the loss and the carry, so that neither
aliases a buffer the next replay rewrites. Capture starts with every
``p.grad`` at ``None``, so the graph owns its gradient buffers; each replay
binds every ``p.grad`` to the buffers of the graph that ran, so that an
interleaved eager step or another graph cannot hand the optimizer stale
gradients. Each replay adds the kernel launches counted during its capture
to ``ops.LAUNCHES``, so a replayed step counts what an eager one does.

A replayed step records the spans ``train.replay`` (copy-in, replay,
copy-out) and, on its first call, ``train.capture``, and the counters
``train_graph_captures`` and ``train_graph_replays``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..ops.cuda_warp import LAUNCHES
from ..utils.diagnostics import annotate, count

MAX_GRAPHS = 16  # signatures a step keeps, warmed up or captured


def uses_graphs(params) -> bool:
    """Does the step replay graphs: does the model lie on a CUDA card?"""
    return bool(params) and params[0].is_cuda


class CudaGraph:
    """``torch.cuda.CUDAGraph`` with its capture as one call."""

    def __init__(self):
        self.graph = torch.cuda.CUDAGraph()

    def capture(self, fn: Callable, pool=None):
        """Capture ``fn()``'s work (none of it runs) into the memory pool
        ``pool`` (a new one: ``None``); returns its result."""
        with torch.cuda.graph(self.graph, pool=pool):
            return fn()

    def pool(self):
        """The handle of the graph's memory pool."""
        return self.graph.pool()

    def replay(self) -> None:
        self.graph.replay()


def _meta(t):
    return None if t is None else (tuple(t.shape), t.dtype, t.device)


def signature(carry, window: Dict[str, Optional[torch.Tensor]]):
    """What a graph is keyed on: the window's keys with each tensor's
    shape, dtype and device, the carry's, and the float32 precision
    settings, which choose the convolutions' kernels."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    return (tuple((k, _meta(v)) for k, v in sorted(window.items())),
            tuple(_meta(c) for c in carry), flags)


class _Graph:
    """One captured step: its input buffers, the graph, its outputs (the
    loss, the new carry, each parameter's gradient) and the kernel launches
    one replay makes."""

    def __init__(self, graph_cls, pool, body, params, carry, window):
        self.window = {k: None if v is None else v.clone()
                       for k, v in window.items()}
        self.carry = tuple(c.clone() for c in carry)
        before = dict(LAUNCHES)
        self.graph = graph_cls()
        try:
            self.loss, self.carry_out, self.grads = self.graph.capture(
                lambda: body(self.carry, self.window)
                + ([p.grad for p in params],), pool)
        finally:
            # the capture ran nothing: its launches count on each replay
            self.launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
            LAUNCHES.update(before)

    def run(self, carry, window) -> Tuple[torch.Tensor, Tuple]:
        for k, v in window.items():
            if v is not None:
                self.window[k].copy_(v)
        for buf, c in zip(self.carry, carry):
            buf.copy_(c)
        self.graph.replay()
        for k, n in self.launches.items():
            LAUNCHES[k] += n
        return self.loss.clone(), tuple(c.clone() for c in self.carry_out)


class StepGraphs:
    """The graphs of one train step. ``body(carry, window) -> (loss,
    carry)`` is the step's device work: it sets every ``p.grad`` of
    ``params`` to ``None``, runs the forward, the loss and the backward,
    and returns the detached loss and carry. ``graph_cls`` makes a graph
    (:class:`CudaGraph`; the tests hand a stand-in). ``graphs`` maps each
    signature kept to its graph, ``None`` until it is captured."""

    def __init__(self, params, body: Callable, graph_cls=CudaGraph):
        self.params, self.body, self.graph_cls = list(params), body, graph_cls
        self.graphs: Dict[tuple, Optional[_Graph]] = {}
        self.pool = None  # the memory pool of the step's graphs

    def __call__(self, carry, window):
        """The step's device work by a replay: ``(loss, carry)``, clones,
        with every ``p.grad`` bound to the gradients of the graph that ran;
        ``None`` where the caller runs the call eagerly: a signature's
        first, or one past the ``MAX_GRAPHS`` kept."""
        key = signature(carry, window)
        if key not in self.graphs:
            if len(self.graphs) < MAX_GRAPHS:
                self.graphs[key] = None  # the warm-up
            return None
        g = self.graphs[key]
        if g is None:
            with annotate("train.capture"):
                g = self.graphs[key] = _Graph(self.graph_cls, self.pool,
                                              self.body, self.params, carry,
                                              window)
            self.pool = g.graph.pool()
            count("train_graph_captures", 1)
        with annotate("train.replay"):
            out = g.run(carry, window)
        for p, grad in zip(self.params, g.grads):
            p.grad = grad
        count("train_graph_replays", 1)
        return out

"""CUDA graphs of a step's device work.

On the card two steps replay their device work as one
``torch.cuda.CUDAGraph`` instead of dispatching it kernel by kernel, since
an eager step leaves the card idle while the host catches up:

  * the train step (:func:`.step.make_train_step`): a window's unpack, its
    P passes, the loss and ``loss.backward()`` (most of that dispatch is
    autograd's backward). The optimizer (the clip pre-hook and the update)
    stays eager after the replay, reading the gradients the graph wrote;
  * the eval window step (:func:`.step.make_eval_window_step`): the u32
    wire's unpack and rectification lookup, the derived inputs, the P
    forwards and validation updates and the window-boundary ``extras``
    (a DSEC GT window of E-RAFT is some 18,000 kernels).

The policy (:class:`StepGraphs`), keyed by what the step observes in its
inputs (:func:`signature`: their structure, each tensor's shape, dtype and
device, which inputs are ``None``, any host value among them, and the
float32 precision settings):

  * the first call of a signature runs eagerly: it is the warm-up, and a
    real step;
  * the second captures the work once, then replays it at once to execute
    that same step; every later call replays;
  * a step keeps the first ``MAX_GRAPHS`` signatures it meets, warmed up
    or captured, and drops none: a signature past them runs eagerly on
    every call. So a run captures at most ``MAX_GRAPHS`` times, whatever
    order its shapes come in, and a graph in use is never dropped for a
    shape that comes once. The training CLI pads a window to a
    power-of-two bucket (``data.base.bucket_size``), so its windows take
    a few signatures, one a bucket its traffic reaches; an eval pipeline
    has one a bucket.

A capture restricts only its own thread (``capture_error_mode=
"thread_local"``): another thread may call CUDA meanwhile, as the eval
CLI's readback thread copies the last window's metrics to the host while
the next window captures, which the default global mode would make fail.
The step cannot drain that reader first: the caller owns it.

The graphs of a step share one memory pool. No two replay at once, each
keeps its input buffers outside the pool and its outputs alive, and a
replay reads nothing of the pool that it did not write itself: so one
graph's intermediates may take another's dead ones, and the step's graphs
hold about the memory of its largest plus their outputs.

A replay copies each input tensor into the graph's buffer for it (a buffer
handed in as the input is not copied onto itself; a host value is read at
capture only, and keyed on), replays, and gives the graph's outputs, in
new containers, to the step's ``hand_back``: it clones what a caller may
still hold while the next replay rewrites it (:func:`clones`). Each replay
adds the kernel launches counted during its capture to ``ops.LAUNCHES``
and records again the counters its capture counted
(``utils.diagnostics.count``, E-RAFT's ``corr_taps``), so a replayed step
counts what an eager one does.

A replayed step records the spans ``<name>.replay`` (copy-in, replay,
hand-back) and, on its first call, ``<name>.capture``, and the counters
``<name>_graph_captures`` and ``<name>_graph_replays``, ``<name>`` the
step's (``train``, ``eval``). The spans inside the work record at capture
only.
"""

from __future__ import annotations

import dataclasses
import gc
from typing import Callable, Dict, Optional

import torch

from ..ops.cuda_warp import LAUNCHES
from ..utils.diagnostics import annotate, count, taped_counts

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
        ``pool`` (a new one: ``None``); returns its result. The garbage
        collector stays off meanwhile: a collection could release a dead
        graph (an eval pipeline's sit in a reference cycle), and freeing
        its memory pool inside a capture invalidates the capture."""
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, pool=pool,
                                  capture_error_mode="thread_local"):
                return fn()
        finally:
            if collecting:
                gc.enable()

    def pool(self):
        """The handle of the graph's memory pool."""
        return self.graph.pool()

    def replay(self) -> None:
        self.graph.replay()


def _flatten(tree, leaves: list):
    """The structure of ``tree`` (hashable), its leaves appended to
    ``leaves``: tuples, lists, dicts and dataclasses are walked, anything
    else (a tensor, ``None``, a host value) is a leaf."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = tuple(f.name for f in dataclasses.fields(tree))
        return (type(tree), names,
                tuple(_flatten(getattr(tree, n), leaves) for n in names))
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return dict, keys, tuple(_flatten(tree[k], leaves) for k in keys)
    if isinstance(tree, (tuple, list)):
        return type(tree), None, tuple(_flatten(t, leaves) for t in tree)
    leaves.append(tree)
    return None


def _unflatten(spec, leaves):
    """A tree of ``spec``'s structure in new containers, its leaves taken
    in turn from the iterator ``leaves``."""
    if spec is None:
        return next(leaves)
    kind, names, children = spec
    items = [_unflatten(c, leaves) for c in children]
    if kind is dict:
        return dict(zip(names, items))
    if names is not None:  # a dataclass
        return kind(**dict(zip(names, items)))
    if hasattr(kind, "_fields"):  # a NamedTuple
        return kind(*items)
    return kind(items)


def clones(tree):
    """``tree`` in new containers, each tensor cloned."""
    leaves = []
    spec = _flatten(tree, leaves)
    return _unflatten(spec, (t.clone() if torch.is_tensor(t) else t
                             for t in leaves))


def _meta(leaf):
    if torch.is_tensor(leaf):
        return tuple(leaf.shape), leaf.dtype, leaf.device
    return leaf  # None, or a host value the capture reads


def signature(*args):
    """What a graph is keyed on: the structure of the step's inputs, each
    tensor's shape, dtype and device, each other leaf (``None``, a host
    value) itself, and the float32 precision settings, which choose the
    convolutions' kernels."""
    leaves = []
    spec = _flatten(args, leaves)
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    return spec, tuple(_meta(leaf) for leaf in leaves), flags


class _Graph:
    """One captured step: the buffers of its inputs, the graph, its outputs
    (``out``, as the capture returned them, and their leaves) and what one
    replay counts: the kernel launches and the program's counters."""

    def __init__(self, graph_cls, pool, body, args):
        leaves = []
        self.spec = _flatten(args, leaves)
        self.inputs = [t.clone() if torch.is_tensor(t) else t
                       for t in leaves]
        before = dict(LAUNCHES)
        self.graph = graph_cls()
        try:
            # the capture runs nothing: its launches and counters count on
            # each replay
            with taped_counts() as self.counts:
                self.out = self.graph.capture(
                    lambda: body(*_unflatten(self.spec, iter(self.inputs))),
                    pool)
        finally:
            self.launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
            LAUNCHES.update(before)
        self.outputs = []
        self.out_spec = _flatten(self.out, self.outputs)

    def run(self, args):
        leaves = []
        _flatten(args, leaves)
        for buf, t in zip(self.inputs, leaves):
            if torch.is_tensor(t) and t.data_ptr() != buf.data_ptr():
                buf.copy_(t)
        self.graph.replay()
        for k, n in self.launches.items():
            LAUNCHES[k] += n
        for name, n in self.counts:
            count(name, n)
        return _unflatten(self.out_spec, iter(self.outputs))


class StepGraphs:
    """The graphs of one step. ``body(*args)`` is the step's device work
    (the caller runs it eagerly where a call returns ``None``); ``name``
    names the spans and counters; ``hand_back(out)`` turns the graph's
    outputs (new containers over its buffers) into what a replayed call
    returns. ``graph_cls`` makes a graph (:class:`CudaGraph`; the tests
    hand a stand-in). ``graphs`` maps each signature kept to its graph,
    ``None`` until it is captured."""

    def __init__(self, name: str, body: Callable, hand_back: Callable,
                 graph_cls=CudaGraph):
        self.name, self.body, self.hand_back = name, body, hand_back
        self.graph_cls = graph_cls
        self.graphs: Dict[tuple, Optional[_Graph]] = {}
        self.pool = None  # the memory pool of the step's graphs

    def __call__(self, *args):
        """The step by a replay: ``hand_back`` of the graph's outputs;
        ``None`` where the caller runs the call eagerly: a signature's
        first, or one past the ``MAX_GRAPHS`` kept."""
        key = signature(*args)
        if key not in self.graphs:
            if len(self.graphs) < MAX_GRAPHS:
                self.graphs[key] = None  # the warm-up
            return None
        g = self.graphs[key]
        if g is None:
            with annotate(self.name + ".capture"):
                g = self.graphs[key] = _Graph(self.graph_cls, self.pool,
                                              self.body, args)
            self.pool = g.graph.pool()
            count(self.name + "_graph_captures", 1)
        with annotate(self.name + ".replay"):
            out = self.hand_back(g.run(args))
        count(self.name + "_graph_replays", 1)
        return out

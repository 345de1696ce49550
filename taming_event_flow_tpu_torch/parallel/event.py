"""Event-axis parallelism of the contrast-max train step on the 2-D
``(data, event)`` mesh: the counterpart of
``taming_event_flow_tpu/parallel/event.py``. The step itself is
``training.step.make_train_step`` with ``mesh=``; this module holds what it
needs of the mesh: the window's shards and the gradients' reduction.

The IWE splat is a sum over events, so each lane's event list splits into
N / E chunks, one per rank of an event group: each rank splats its chunk
into a full-resolution partial IWE, and one all-reduce over the event group
merges the partials before the focus loss normalises them
(``objectives/base.py: iwe_with_ts``). Everything before the splat (flow
gathers, propagation, purging) is per event and needs no communication.

  * data axis: batch lanes (independent event streams, carry included);
    its one collective is the gradient's sum.
  * event axis: the per-IWE all-reduces (``[B_local, H, W, 4]`` float32,
    one per IWE) and the gradient's mean.

The model runs replicated over the event axis: every rank of an event group
holds the lanes' whole net input. Padding events carry zero polarity
masks, so an uneven share of real events between ranks changes nothing.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from .mesh import Mesh, take

EVENT_AXIS = "event"

# window entries sliced on N (axis 2 of [P, B, N, C]); net_input is
# replicated over the event axis
_EVENT_KEYS = ("event_list", "pol_mask", "grad_mask")
_WINDOW_KEYS = ("net_input",) + _EVENT_KEYS


def shard_window_2d(window: Dict, mesh: Mesh,
                    local_lanes: bool = False) -> Dict:
    """This rank's part of a pass-stacked window: its lanes of every entry
    (unless ``local_lanes`` says the window holds only them already, as the
    training CLI's loader streams it) and its N / E events of
    ``event_list``, ``pol_mask`` and ``grad_mask``. ``net_input`` is
    replicated over the event axis: the model runs on every rank."""
    unknown = set(window) - set(_WINDOW_KEYS)
    if unknown or "net_input" not in window:
        raise ValueError(f"a sharded window holds {_WINDOW_KEYS}, got "
                         f"{sorted(window)}")
    out = {}
    for k, v in window.items():
        if not local_lanes:
            v = take(v, 1, *mesh.lanes(v.shape[1]))
        if k in _EVENT_KEYS:
            v = take(v, 2, *mesh.events(v.shape[2]))
        out[k] = v
    return out


def reduce_gradients(params, mesh: Mesh) -> None:
    """Sum the parameters' gradients over the data axis and average them
    over the event axis, in place: one all-reduce of the flattened
    gradients over the world, divided by ``n_event``.

    The event axis's mean is exact: the loss's IWE all-reduces hand every
    event rank an E-fold cotangent (the transpose of a sum is a sum), so
    each rank's gradient is E times its shard's contribution, for the
    event paths and the replicated ones (the smoothness terms) alike, as in
    the JAX step. A gradient summed over lanes, not averaged, is what the
    JAX step computes, so ``DistributedDataParallel``, which averages, is
    not used.
    """
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    if mesh.n_event > 1:
        flat /= mesh.n_event
    offset = 0
    for p, g in zip(params, grads):
        p.grad = flat[offset:offset + g.numel()].view_as(g)
        offset += g.numel()


"""Event-axis parallelism of the contrast-max train step on the 2-D
``(data, event)`` mesh: the counterpart of
``taming_event_flow_tpu/parallel/event.py``.

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

from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from .mesh import Mesh, shard_state, take

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


def shard_state_2d(state, mesh: Mesh):
    """This rank's lanes of the carry; the parameters and the optimizer
    state are replicated (:func:`.mesh.replicate`)."""
    return shard_state(state, mesh)


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


def make_event_parallel_train_step(
    model,
    optimizer,
    loss_cfg,
    mesh: Mesh,
    warping: str = "Iterative",
    flow_scaling: float = 32.0,
    res: Optional[tuple] = None,
) -> Callable:
    """The window step over a ``(data, event)`` mesh, with the contract of
    :func:`..training.step.make_train_step`; call it with this rank's part
    of the window (:func:`shard_window_2d`) and of the state
    (:func:`shard_state_2d`), after the model and optimizer were
    replicated (:func:`.mesh.replicate`).

    In order: the P passes (replicated over the event axis), the loss with
    the event group as its ``event_axis``, the backward, the gradients'
    data sum and event mean (:func:`reduce_gradients`), then the clip and
    the optimizer on the reduced gradients (the clip sees the global norm).
    The loss comes back summed over the data axis, the same on every rank.
    ``n_event = 1`` is plain data parallelism.
    """
    # imported here: the losses import this package's collectives
    from ..objectives import LOSS_REGISTRY
    from ..training.step import TrainState, run_passes, unpack_window

    loss_fn = LOSS_REGISTRY[warping]
    params = [p for p in model.parameters() if p.requires_grad]

    def step(state: TrainState, raw_window: Dict[str, torch.Tensor]):
        if mesh.n_event > 1 and "net_input" not in raw_window:
            # derived from this rank's events alone it would be wrong
            raise ValueError("an event-sharded window needs its net_input")
        window = unpack_window(raw_window, res=res)
        for p in params:
            p.grad = None
        with torch.enable_grad():
            flows, carry = run_passes(model, state.carry,
                                      window["net_input"], flow_scaling)
            loss = loss_fn(flows, window["event_list"], window["pol_mask"],
                           window["grad_mask"], loss_cfg,
                           event_axis=mesh.event_group)
            loss.backward()
        reduce_gradients(params, mesh)
        optimizer.step()
        loss = loss.detach().clone()
        dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=mesh.data_group)
        carry = tuple(c.detach() for c in carry)
        return TrainState(carry, state.step + 1), loss

    return step

"""Event-sharded evaluation: the counterpart of
``taming_event_flow_tpu/parallel/eval.py``.

Eval runs at batch 1, so its one parallel axis is the event dimension of
the validation slot state. Each rank holds N / E slots of every pass
(:func:`shard_val_state`) and ingests its N / E events of each batch
(:func:`shard_eval_batch`); the per-event warp of the update needs no
collective. The flow maps and the pixel-space accumulators are replicated:
every rank runs the model on the whole batch's input. The window reducers
(FWL, RSAT, the window IWEs) merge their partial images with one all-reduce
over the event group before any variance or ratio
(:func:`make_sharded_reducers`).

``round_ts`` must be off: its min over a pass's events would become a
per-shard min.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

from .mesh import Mesh, make_event_mesh, take, world_size

EVAL_EVENT_AXIS = "event"

# ValState fields whose axis 2 is the event dimension ([P, B, N, ...])
_EVENT_FIELDS = (
    "event_ts", "event_loc", "pol_mask",
    "fw_loc", "fw_ts", "fw_mask", "bw_loc", "bw_mask",
)


def make_eval_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The 1-D event mesh over the world (``n_devices`` ranks, all of them
    by default)."""
    return make_event_mesh(1, n_devices or world_size())


def shard_val_state(state, mesh: Mesh, round_ts: bool = False):
    """This rank's N / E slots of a ``ValState`` (the event-dimension
    buffers sliced on N, the rest replicated).

    :param round_ts: the protocol's ``round_ts`` flag: sharding is refused
        when it is on.
    """
    if round_ts:
        raise ValueError(
            "round_ts is incompatible with event-axis sharding: its min "
            "over events would become a per-shard min. Run unsharded.")
    return dataclasses.replace(state, **{
        name: take(getattr(state, name), 2,
                   *mesh.events(getattr(state, name).shape[2]))
        for name in _EVENT_FIELDS})


def shard_eval_batch(event_list, pol_mask, mesh: Mesh):
    """This rank's events of per-pass inputs ``[B, N, ...]``."""
    lo, hi = mesh.events(event_list.shape[1])
    return take(event_list, 1, lo, hi), take(pol_mask, 1, lo, hi)


def shard_eval_window(event_lists, pol_masks, mesh: Mesh):
    """This rank's events of pass-stacked inputs ``[P, B, N, ...]``."""
    lo, hi = mesh.events(event_lists.shape[2])
    return take(event_lists, 2, lo, hi), take(pol_masks, 2, lo, hi)


def make_sharded_reducers(criteria, mesh: Optional[Mesh] = None):
    """The window reducers of ``criteria`` with the event group as their
    ``event_axis`` (none without a mesh): ``fwl``, ``rsat``, ``rsat_fwl``,
    ``window_events``, ``window_iwe_fw`` and ``window_iwe_bw``, each taking
    the slot state. ``window_flow`` reads only replicated pixel
    accumulators and takes the criteria's own method."""
    axis = None if mesh is None else mesh.event_group

    def bind(fn, **kw):
        return functools.partial(fn, event_axis=axis, **kw)

    return {
        "fwl": bind(criteria.fwl),
        "rsat": bind(criteria.rsat),
        "rsat_fwl": bind(criteria.rsat_fwl),
        "window_events": bind(criteria.window_events),
        "window_iwe_fw": bind(criteria.window_iwe, mode="forward"),
        "window_iwe_bw": bind(criteria.window_iwe, mode="backward"),
    }

"""The device mesh of the port: ranks laid out as an ``(n_data, n_event)``
grid, one process and one device per rank. The counterpart of
``taming_event_flow_tpu/parallel/mesh.py`` (the 1-D data mesh) and of the
mesh half of its ``event.py`` and ``eval.py``.

In JAX a mesh axis is a name inside one SPMD program; here each axis is a
process group. The event axis is innermost: the ranks of one event group
are consecutive (rank ``d * n_event + e`` holds data index ``d`` and event
index ``e``), which keeps the event ring inside one host under
``torchrun``, as ``make_multihost_event_mesh`` does in JAX.

Placement maps to slicing: ``P(DATA_AXIS)`` is "this rank holds lanes
``[d B / n_data, (d + 1) B / n_data)``"
(:func:`batch_sharding`), and the replicated parameters are broadcast from
rank 0 once, then checked bit for bit (:func:`replicate`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the ``(n_data, n_event)`` grid and the process
    groups of its two axes.

    ``data_group`` holds the ranks that share this rank's event index (the
    train step's loss sums over it), ``event_group`` the ranks that share
    its lanes (the partial IWEs merge over it); the mesh holds the whole
    world. ``flag_group`` is a gloo group over the world for the loader's
    host flags (:func:`..multihost.exchange_flags`), so their exchange can
    run on the loader's thread beside the step's collectives.
    """

    n_data: int
    n_event: int
    rank: int
    data_group: object
    event_group: object
    flag_group: object

    @property
    def data_index(self) -> int:
        return self.rank // self.n_event

    @property
    def event_index(self) -> int:
        return self.rank % self.n_event

    def lanes(self, batch: int):
        """This rank's ``(start, stop)`` of ``batch`` lanes."""
        return _split(batch, self.n_data, self.data_index, "batch lanes",
                      "data")

    def events(self, n: int):
        """This rank's ``(start, stop)`` of ``n`` events a lane."""
        return _split(n, self.n_event, self.event_index, "events", "event")


def _split(n: int, parts: int, index: int, what: str, axis: str):
    if n % parts:
        raise ValueError(f"{n} {what} do not split evenly over the {axis} "
                         f"axis of {parts} ranks")
    per = n // parts
    return index * per, (index + 1) * per


def world_size() -> int:
    """The number of ranks: 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _my_group(rank: int, rank_lists: Sequence[Sequence[int]]):
    """Create every group of ``rank_lists`` (every rank must create every
    group, in the same order) and return the one holding ``rank``."""
    mine = None
    for ranks in rank_lists:
        group = dist.new_group(list(ranks))
        if rank in ranks:
            mine = group
    return mine


def make_event_mesh(n_data: int, n_event: int) -> Mesh:
    """The ``(data, event)`` mesh over the world, which must hold exactly
    ``n_data * n_event`` ranks. Every rank must call it, in the same order
    as every other collective.

    :raises ValueError: for a shape the world cannot hold, or an event axis
        that does not divide the ranks of one host (``LOCAL_WORLD_SIZE``,
        set by ``torchrun``), which would stretch the event ring across
        hosts.
    """
    if n_data < 1 or n_event < 1:
        raise ValueError(f"mesh axes must be positive, got {n_data}x"
                         f"{n_event}")
    need, have = n_data * n_event, world_size()
    if have < need:
        raise ValueError(
            f"need {need} ranks for a {n_data}x{n_event} (data x event) "
            f"mesh, the world holds {have}: launch that many processes "
            "(torchrun --nproc_per_node); multi-card scaling is unmeasured, "
            "see ROADMAP.md section 2, item 8")
    if have > need:
        raise ValueError(
            f"a {n_data}x{n_event} (data x event) mesh takes {need} ranks, "
            f"the world holds {have}: every rank needs a place in the mesh")
    local = os.environ.get("LOCAL_WORLD_SIZE")
    if local is not None and int(local) % n_event:
        raise ValueError(
            f"event axis ({n_event}) must divide the ranks of one host "
            f"({local}) so its all-reduces stay inside the host")
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.init_distributed "
                           "first")
    rank = dist.get_rank()
    event_group = _my_group(rank, [
        range(d * n_event, (d + 1) * n_event) for d in range(n_data)])
    data_group = _my_group(rank, [
        range(e, need, n_event) for e in range(n_event)])
    flag_group = dist.new_group(list(range(need)), backend="gloo")
    return Mesh(n_data, n_event, rank, data_group, event_group, flag_group)


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D data-parallel mesh over the world (``n_devices`` ranks, all of
    them by default)."""
    return make_event_mesh(n_devices or world_size(), 1)


def take(v, axis: int, start: int, stop: int):
    """``v[..., start:stop, ...]`` on ``axis``, contiguous (a numpy array or
    a tensor)."""
    s = v[(slice(None),) * axis + (slice(start, stop),)]
    return s.contiguous() if torch.is_tensor(s) else np.ascontiguousarray(s)


def batch_sharding(mesh: Mesh, batch_axis: int = 1):
    """This rank's lanes of an array whose ``batch_axis`` holds the global
    batch (a pass-stacked window ``[P, B, ...]`` by default): the
    counterpart of ``NamedSharding(mesh, P(None, DATA_AXIS))``."""
    def shard(v):
        return take(v, batch_axis, *mesh.lanes(v.shape[batch_axis]))

    return shard


def shard_window(window, mesh: Mesh):
    """This rank's lanes of a pass-stacked window dict (global batch)."""
    shard = batch_sharding(mesh, batch_axis=1)
    return {k: shard(v) for k, v in window.items()}


def shard_state(state, mesh: Mesh):
    """This rank's lanes of a ``TrainState``'s carry (global batch); the
    parameters and optimizer state are replicated by :func:`replicate`."""
    shard = batch_sharding(mesh, batch_axis=0)
    return state._replace(carry=tuple(shard(c) for c in state.carry))


def _comm_device(group) -> torch.device:
    """Where a tensor of ``group``'s collectives lives: the current card
    for NCCL, the host for gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _replicated_tensors(model, optimizer=None):
    out = list(model.state_dict().values())
    if optimizer is not None:
        for group in optimizer.param_groups:
            for p in group["params"]:
                state = optimizer.state.get(p, {})
                out += [state[k] for k in sorted(state)
                        if torch.is_tensor(state[k])]
    return out


def check_replicated(tensors, group=None) -> None:
    """Raise unless every rank of ``group`` (the world by default) holds
    the same bits in ``tensors`` (compared byte for byte: a max and a min
    all-reduce)."""
    group = dist.group.WORLD if group is None else group
    dev = _comm_device(group)
    flat = torch.cat([t.detach().reshape(-1).contiguous().view(torch.uint8)
                      .to(dev) for t in tensors]).to(torch.int32)
    hi, lo = flat.clone(), flat
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
    if not torch.equal(hi, lo):
        raise RuntimeError("replicated tensors differ between ranks")


def replicate(model, optimizer=None) -> None:
    """Broadcast the model's parameters and buffers, and the optimizer's
    state, from rank 0 to every rank, in place, then check that every rank
    holds the same bits. The counterpart of placing them with ``P()``."""
    group = dist.group.WORLD
    dev = _comm_device(group)
    tensors = _replicated_tensors(model, optimizer)
    with torch.no_grad():
        for t in tensors:
            buf = t.detach().to(dev)
            dist.broadcast(buf, src=0, group=group)
            t.copy_(buf)
    check_replicated(tensors, group)

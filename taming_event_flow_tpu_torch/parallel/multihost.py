"""Process start-up and the loader's per-batch flags: the counterpart of
``taming_event_flow_tpu/parallel/multihost.py``.

Every rank is a process with one device, so the port's multi-host path and
its one-host path are the same code. ``globalize_window`` and
``globalize_state`` have no counterpart: they assemble JAX's global arrays
from per-process shards, and here every process already holds only its own
tensors.

Batch lanes partition over the data axis: a rank streams the lanes of its
data index (:func:`local_lane_range`) from its round-robin shard of the
seeded file list (``H5Loader(lane_offset=..., file_shard=...)``), and the
ranks of one event group stream the same lanes. Rollover and the epoch
boundary then differ between ranks, so the loader's flags are exchanged
once a batch (:func:`exchange_flags`) and every rank takes the same reset
and epoch decisions; a rank that skipped a collective would hang the rest.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from .mesh import Mesh, make_event_mesh, world_size


def init_distributed(parallel_cfg: Optional[Dict] = None, backend=None,
                     device=None) -> bool:
    """Initialize the process group if a rendezvous is configured.

    Sources, in order:
      1. the ``parallel`` config keys ``coordinator`` (``"host:port"``, or
         a URL such as ``file:///path``), ``num_processes`` and
         ``process_id``;
      2. ``torchrun``'s environment: ``MASTER_ADDR``, ``MASTER_PORT``,
         ``WORLD_SIZE``, ``RANK`` (and ``LOCAL_RANK`` for the device).

    The rank's device is ``device``, else ``cuda:<LOCAL_RANK>`` (see
    :func:`..utils.device.resolve_device`); a device that does not exist
    raises. The backend is ``backend``, else NCCL for a CUDA device and gloo
    for the CPU (gloo with a CUDA device runs several ranks on one card). A
    failed initialization raises; nothing is retried on another backend.

    :return: True when a process group is initialized (already, or now,
        a world of one included), False when no rendezvous is configured.
    """
    if dist.is_initialized():
        return True
    cfg = dict(parallel_cfg or {})
    env = os.environ
    if cfg.get("coordinator"):
        coord = str(cfg["coordinator"])
        num, rank = cfg.get("num_processes"), cfg.get("process_id")
        if num is None or rank is None:
            raise ValueError("parallel.coordinator needs num_processes and "
                             "process_id")
    elif all(k in env for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK")):
        coord = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
        num, rank = env["WORLD_SIZE"], env["RANK"]
    else:
        return False
    dev = resolve_device("cuda" if device is None else device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=coord if "://" in coord else f"tcp://{coord}",
        world_size=int(num), rank=int(rank))
    return True


def make_multihost_event_mesh(n_event: int = 1) -> Mesh:
    """The ``(world / n_event, n_event)`` mesh: the event groups are
    consecutive ranks, inside one host when ``n_event`` divides its ranks
    (checked by :func:`.mesh.make_event_mesh`)."""
    if n_event < 1 or world_size() % n_event:
        raise ValueError(f"event axis ({n_event}) must divide the world "
                         f"({world_size()} ranks)")
    return make_event_mesh(world_size() // n_event, n_event)


def local_lane_range(global_batch: int,
                     mesh: Optional[Mesh] = None) -> Tuple[int, int]:
    """This rank's ``(start, stop)`` of the global batch lanes: by data
    index on ``mesh``, else by rank over the world (``(0, B)`` without a
    process group).

    :raises ValueError: when the data axis does not divide the batch.
    """
    if mesh is not None:
        return mesh.lanes(global_batch)
    n = world_size()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} must split evenly "
                         f"over {n} processes")
    per = global_batch // n
    rank = dist.get_rank() if dist.is_initialized() else 0
    return rank * per, (rank + 1) * per


def shared_seed(seed=None):
    """``seed``, or over several ranks without one, a seed drawn on rank 0
    and broadcast to every rank: ranks that stream the same batches must
    permute the files alike, which unseeded loaders would not."""
    if seed is not None or world_size() == 1:
        return seed
    box = [int(np.random.SeedSequence().entropy % 2**63)
           if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def exchange_flags(new_seq_local, epoch_done_local: bool,
                   mesh: Mesh) -> Tuple[np.ndarray, bool]:
    """Per-batch exchange of the loader's control flags over the world.

    :param new_seq_local: ``[B_local]`` bool, this rank's lane resets.
    :param epoch_done_local: this rank's lanes all finished their epoch.
    :return: ``(new_seq_global [B_global], epoch_done_all)``: the reset
        mask of every lane in data-index order, and whether every rank
        finished (the epoch barrier).

    The flags travel as CPU tensors on ``mesh.flag_group`` (gloo, whatever
    the step's backend), so the loader's thread can exchange them while the
    main thread runs the step's collectives on the other groups.
    """
    flags = torch.from_numpy(np.concatenate([
        np.asarray(new_seq_local, np.float32),
        np.asarray([epoch_done_local], np.float32)]))
    out = [torch.empty_like(flags) for _ in range(world_size())]
    dist.all_gather(out, flags, group=mesh.flag_group)
    grid = torch.stack(out).numpy().reshape(mesh.n_data, mesh.n_event, -1)
    if not (grid == grid[:, :1]).all():
        raise RuntimeError("the ranks of one event group streamed different "
                           "lanes")
    return grid[:, 0, :-1].reshape(-1) > 0, bool(grid[..., -1].all())

"""The multi-device layer of the port, on ``torch.distributed``: the
counterpart of ``taming_event_flow_tpu/parallel/``.

Each device is a process and each mesh axis a process group
(:class:`.mesh.Mesh`): ``psum`` over an axis is an all-reduce over that
axis's group (:mod:`.collectives`), a ``PartitionSpec`` is the slice of the
batch lanes or events this rank holds, and a replicated array is a tensor
broadcast from rank 0 once. Launch under ``torchrun`` (or
:func:`.spawn.run_ranks` in tests); :func:`init_distributed` reads its
environment.

The JAX package's ``globalize_window`` and ``globalize_state`` have no
counterpart: they assemble global arrays from per-process shards, and here
every process already holds only its own tensors.
"""

from .collectives import all_reduce_sum, pmean
from .eval import (
    EVAL_EVENT_AXIS,
    make_eval_mesh,
    make_sharded_reducers,
    shard_eval_batch,
    shard_eval_window,
    shard_val_state,
)
from .event import (
    EVENT_AXIS,
    reduce_gradients,
    shard_window_2d,
)
from .mesh import (
    DATA_AXIS,
    Mesh,
    batch_sharding,
    check_replicated,
    make_event_mesh,
    make_mesh,
    replicate,
    shard_state,
    shard_window,
    world_size,
)
from .multihost import (
    exchange_flags,
    init_distributed,
    local_lane_range,
    make_multihost_event_mesh,
    shared_seed,
)

__all__ = [
    "all_reduce_sum",
    "pmean",
    "EVAL_EVENT_AXIS",
    "make_eval_mesh",
    "make_sharded_reducers",
    "shard_eval_batch",
    "shard_eval_window",
    "shard_val_state",
    "EVENT_AXIS",
    "make_event_mesh",
    "reduce_gradients",
    "shard_window_2d",
    "DATA_AXIS",
    "Mesh",
    "make_mesh",
    "shard_window",
    "shard_state",
    "replicate",
    "check_replicated",
    "batch_sharding",
    "world_size",
    "exchange_flags",
    "init_distributed",
    "local_lane_range",
    "make_multihost_event_mesh",
    "shared_seed",
]

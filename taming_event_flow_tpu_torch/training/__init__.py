from .step import (
    TrainState,
    build_optimizer,
    clip_by_global_norm_,
    init_train_state,
    make_eval_step,
    make_eval_window_step,
    make_forward_fn,
    make_train_step,
    reset_carry,
    run_passes,
    unpack_window,
)
from .window import (
    WindowGrouper,
    pack_net_input,
    pad_batch_events,
    stack_window,
)

__all__ = [
    "TrainState",
    "build_optimizer",
    "clip_by_global_norm_",
    "init_train_state",
    "make_train_step",
    "run_passes",
    "unpack_window",
    "make_eval_step",
    "make_eval_window_step",
    "make_forward_fn",
    "reset_carry",
    "pad_batch_events",
    "stack_window",
    "pack_net_input",
    "WindowGrouper",
]

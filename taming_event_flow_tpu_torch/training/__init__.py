from .step import (
    make_eval_step,
    make_eval_window_step,
    make_forward_fn,
    reset_carry,
)
from .window import pad_batch_events

__all__ = [
    "make_eval_step",
    "make_eval_window_step",
    "make_forward_fn",
    "reset_carry",
    "pad_batch_events",
]

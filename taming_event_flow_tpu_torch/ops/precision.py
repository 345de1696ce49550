"""Float32 precision and determinism on the card.

A float32 convolution goes through cuDNN in TF32 by default, a float32
matrix product does not. The port states both: :func:`set_tf32` sets the two
flags together, and every entry point that compares numbers calls it.
Some of cuDNN's backward algorithms reduce with atomics, in an order that
changes from run to run: :func:`set_deterministic` keeps cuDNN to its
deterministic algorithms, and every entry point that trains or evaluates
calls it, so that a seeded run repeats bit for bit on the card.
"""

from __future__ import annotations

import torch


def set_tf32(enabled: bool) -> None:
    """Allow (or forbid) TF32 for both cuDNN convolutions and matmuls."""
    torch.backends.cudnn.allow_tf32 = bool(enabled)
    torch.backends.cuda.matmul.allow_tf32 = bool(enabled)


def set_deterministic() -> None:
    """Keep cuDNN to deterministic algorithms, chosen without timing runs
    (``benchmark`` off). Not ``torch.use_deterministic_algorithms``, which
    would also swap the count planes' ``index_add_`` for a sort, where
    sums of small integers are exact in any order."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False

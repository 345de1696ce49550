"""Float32 precision on the card.

A float32 convolution goes through cuDNN in TF32 by default, a float32
matrix product does not. The port states both: :func:`set_tf32` sets the two
flags together, and every entry point that compares numbers calls it.
"""

from __future__ import annotations

import torch


def set_tf32(enabled: bool) -> None:
    """Allow (or forbid) TF32 for both cuDNN convolutions and matmuls."""
    torch.backends.cudnn.allow_tf32 = bool(enabled)
    torch.backends.cuda.matmul.allow_tf32 = bool(enabled)

"""The plain reference the benchmark holds the program to: frozen copies,
not imports, of the port's model, losses, optimizer, validation, count
encoding, rectification lookup and u16 lattice, written in plain PyTorch
(no kernels of the port, nothing of the port imported).

Copied from ``taming_event_flow_tpu_torch`` at commit 96ab861; each module
names the port module it copies and every departure from it. The reference
computes in float32 with TF32 off (:func:`no_tf32`), and in the precision
the configuration states where it says otherwise (the bf16 eval forward).
"""

from __future__ import annotations

import torch


def no_tf32() -> None:
    """Float32 convolutions and matrix products without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

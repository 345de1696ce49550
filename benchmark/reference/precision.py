"""The controls' lower precisions, as roundings of a convolution's input
and weight (what the tensor cores do to their operands): the reference
computed with them stands in the program's place to show that the
comparison fails a precision one step below the configuration's.

* ``tf32`` (for float32 with TF32 off): round to TF32's 10-bit mantissa,
  to nearest, ties to even; the product then accumulates in float32.
* ``fp8`` (for bfloat16): scale each tensor by its largest magnitude onto
  float8 e4m3's range (448), round to e4m3 and scale back; the convolution
  then runs in bfloat16.

The rounding passes the gradient through unchanged, so a training control
differentiates the rounded forward.
"""

from __future__ import annotations

import torch


def _straight_through(x, q):
    """``q`` in the forward, the identity in the backward."""
    if not x.requires_grad:
        return q
    return x + (q - x).detach()


def tf32(x):
    if x.dtype != torch.float32:
        return x
    bits = x.detach().contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return _straight_through(x, bits.view(torch.float32))


def fp8(x):
    f = x.detach().float()
    scale = f.abs().amax().clamp(min=1e-30) / 448.0
    q = (f / scale).to(torch.float8_e4m3fn).float() * scale
    return _straight_through(x, q.to(x.dtype))


QUANT = {"tf32": tf32, "fp8": fp8}


def control_for(dtype_name: str) -> str:
    """The control's precision for a configuration's: float32 -> tf32,
    bfloat16 -> fp8."""
    return {"float32": "tf32", "bfloat16": "fp8"}[dtype_name]

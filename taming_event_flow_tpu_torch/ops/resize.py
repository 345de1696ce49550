"""Bilinear upsampling by an integer factor whose backward is a gather.

The forward is ``F.interpolate(mode="bilinear", align_corners=False)``
(half-pixel centres, the edges clamped, as ``jax.image.resize(method=
"bilinear")`` upsamples). Its CUDA backward adds into the input's gradient
with atomics, in an order that changes from run to run, and has no
deterministic version. :class:`UpsampleBilinearFn`'s backward is the
adjoint written as a gather instead: along an axis upsampled by ``s``,
output ``j = q s + r`` reads its source coordinate ``q + d_r``, ``d_r =
(r + 0.5) / s - 0.5``, so each input row gets the output rows of its own
cell and one neighbour's, with weights that repeat with period ``s``. For
``s = 2``::

    out[2i]     = 0.75 in[i] + 0.25 in[max(i - 1, 0)]
    out[2i + 1] = 0.75 in[i] + 0.25 in[min(i + 1, n - 1)]

The backward sums those terms in a fixed order with slices and weighted
adds, the same on every run and on every device. The JAX package computes
this resize with XLA, outside any Pallas kernel.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F


def _phase_weights(s: int) -> List[Tuple[float, float, int]]:
    """Per phase ``r`` of an axis upsampled by ``s``: ``(own weight,
    neighbour weight, neighbour offset)``; the neighbour is the next input
    row (+1) when the source coordinate lies past the row's centre, else
    the previous one (-1)."""
    out = []
    for r in range(s):
        d = (r + 0.5) / s - 0.5
        out.append((1.0 - abs(d), abs(d), 1 if d >= 0 else -1))
    return out


def _adjoint_axis(g, s: int, dim: int):
    """The adjoint of upsampling axis ``dim`` of ``g`` (float32) by ``s``:
    ``g`` has ``n * s`` rows there, the result ``n``."""
    g = g.movedim(dim, -1)
    n = g.shape[-1] // s
    g = g.reshape(*g.shape[:-1], n, s)
    own = nxt = prv = None
    for r, (w_own, w_nb, off) in enumerate(_phase_weights(s)):
        gr = g[..., r]
        own = gr * w_own if own is None else own.add_(gr, alpha=w_own)
        if w_nb == 0.0:
            continue
        if off > 0:
            nxt = gr * w_nb if nxt is None else nxt.add_(gr, alpha=w_nb)
        else:
            prv = gr * w_nb if prv is None else prv.add_(gr, alpha=w_nb)
    # row i takes its own cell's terms, the next-neighbour terms of row
    # i - 1 and the previous-neighbour terms of row i + 1; at the edges the
    # clamped neighbour is the row itself
    if nxt is not None:
        own[..., 1:] += nxt[..., :-1]
        own[..., -1:] += nxt[..., -1:]
    if prv is not None:
        own[..., :-1] += prv[..., 1:]
        own[..., :1] += prv[..., :1]
    return own.movedim(-1, dim)


def upsample_bilinear_backward(g, factor: int):
    """The gradient of :func:`upsample_bilinear` with respect to its input,
    for the cotangent ``g [B, C, s H, s W]``: summed in float32 in a fixed
    order, cast once to ``g``'s type."""
    gin = _adjoint_axis(g.float(), factor, -1)
    gin = _adjoint_axis(gin, factor, -2)
    return gin.to(g.dtype)


class UpsampleBilinearFn(torch.autograd.Function):
    """:func:`upsample_bilinear` as an autograd Function."""

    @staticmethod
    def forward(ctx, x, factor: int):
        ctx.factor = factor
        return F.interpolate(x, scale_factor=factor, mode="bilinear",
                             align_corners=False)

    @staticmethod
    def backward(ctx, g):
        return upsample_bilinear_backward(g, ctx.factor), None


def upsample_bilinear(x, factor: int):
    """Bilinear upsampling of ``x [B, C, H, W]`` by the integer ``factor``
    along both axes (half-pixel centres, edges clamped), with a
    deterministic backward (see the module). Raises for a factor that is not
    a positive integer."""
    if isinstance(factor, bool) or not isinstance(factor, int) or factor < 1:
        raise ValueError(f"upsample_bilinear takes a positive integer "
                         f"factor, got {factor!r}")
    if x.dim() != 4:
        raise ValueError(f"upsample_bilinear takes [B, C, H, W], got "
                         f"{tuple(x.shape)}")
    return UpsampleBilinearFn.apply(x, factor)

"""Event-warping ops: the PyTorch counterpart of
``taming_event_flow_tpu/ops/warp.py``.

Same conventions as the JAX package: event locations ``[B, N, 2]`` in
``(y, x)``, timestamps ``[B, N, 1]``, polarity masks ``[B, N, 2]``, flow
maps ``[B, H, W, 2]`` in ``(x, y)`` order, images NHWC. Padding rows carry
zero masks and drop out of every splat.

The JAX package routes ``gather_values``/``splat_values`` through several
TPU formulations (``ops/backend.py``, ``ops/mxu_lookup.py``, Pallas); here
both are the one splat/gather pair of :mod:`.cuda_warp`, differentiable on
either device through its autograd Functions (under ``torch.inference_mode``
they launch the forward kernels alone).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .cuda_warp import GatherBilinearFn, SplatBilinearFn

Res = Tuple[int, int]  # (H, W)


def event_propagation(event_ts, event_loc, event_flow, tref):
    """``loc' = loc + (tref - ts) * flow`` with per-event flow in (y, x)."""
    return event_loc + (tref - event_ts) * event_flow


def inside_mask(loc, res: Res):
    """``[..., 1]`` float mask of locations inside ``[0, res-1]`` on both
    axes (the boundary rule is ``<= res - 1``)."""
    inside = (
        (loc[..., 0:1] >= 0)
        & (loc[..., 0:1] <= res[0] - 1.0)
        & (loc[..., 1:2] >= 0)
        & (loc[..., 1:2] <= res[1] - 1.0)
    )
    return inside.to(loc.dtype)


def purge_unfeasible(event_loc, pol_mask, res: Res):
    """Move out-of-frame events to ``(0, 0)`` and zero their mask."""
    inside = inside_mask(event_loc, res)
    return event_loc * inside, pol_mask * inside


def gather_values(maps, loc):
    """Bilinear gather of ``maps [B, H, W, C]`` at ``loc [B, M, 2]`` (y, x)
    -> ``[B, M, C]``; out-of-frame taps contribute zero."""
    return GatherBilinearFn.apply(maps.float().contiguous(),
                                  loc.float().contiguous())


def get_event_flow(flow_map, event_loc):
    """Flow map ``[B, H, W, 2]`` (x, y) sampled at event locations
    -> ``[B, N, 2]`` per-event flow in (y, x) order."""
    return gather_values(flow_map, event_loc).flip(-1)


def splat_values(loc, values, res: Res, round_idx: bool = False):
    """Bilinear splat ``out[h, w, c] = sum_e tri(y_e - h) tri(x_e - w)
    values[e, c]`` -> ``[B, H, W, C]``. ``round_idx`` rounds the locations
    half-to-even first (no gradient through the rounding)."""
    if round_idx:
        loc = torch.round(loc).detach()
    return SplatBilinearFn.apply(loc.float().contiguous(),
                                 values.float().contiguous(), tuple(res))


def iwe_from_events(warped_loc, pol_mask, res: Res, round_idx: bool = False,
                    extra_weights=None):
    """Per-polarity image of warped events ``[B, H, W, 2]``."""
    vals = pol_mask if extra_weights is None else pol_mask * extra_weights
    return splat_values(warped_loc, vals, res, round_idx=round_idx)

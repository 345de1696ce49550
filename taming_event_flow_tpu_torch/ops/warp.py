"""Event-warping ops: the PyTorch counterpart of
``taming_event_flow_tpu/ops/warp.py``.

Same conventions as the JAX package: event locations ``[B, N, 2]`` in
``(y, x)``, timestamps ``[B, N, 1]``, polarity masks ``[B, N, 2]``, flow
maps ``[B, H, W, 2]`` in ``(x, y)`` order, images NHWC. Padding rows carry
zero masks and drop out of every splat.

The JAX package routes ``gather_values``/``splat_values`` through several
TPU formulations (``ops/backend.py``, ``ops/mxu_lookup.py``, Pallas) and
``gather_pixels`` through XLA's row gather; here the bilinear pair is the
one splat/gather pair of :mod:`.cuda_warp`, differentiable on either device
through its autograd Functions (under ``torch.inference_mode`` they launch
the forward kernels alone), and ``gather_pixels`` is its row gather, which
has no gradient. The index splats (``splat_channels``, ``splat_bilinear``,
``interpolate``) go through the same splat at integer locations.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .cuda_warp import GatherBilinearFn, SplatBilinearFn, row_gather

Res = Tuple[int, int]  # (H, W)


def event_propagation(event_ts, event_loc, event_flow, tref):
    """``loc' = loc + (tref - ts) * flow`` with per-event flow in (y, x)."""
    return event_loc + (tref - event_ts) * event_flow


def gather_pixels(table, idx):
    """Per-lane lookup ``out[b, n] = table[b, idx[b, n]]``, as one
    :func:`.cuda_warp.row_gather` over the ``B * T`` rows of all lanes.
    An index outside ``[0, T - 1]`` is clamped to its lane's first or last
    entry (the row gather's rule; the JAX formulations differ among
    themselves there, the one-hot form reading zero).

    :param table: ``[B, T]`` values, or ``[B, T, W]`` rows of ``W`` values.
    :param idx: ``[B, N]`` integer indices.
    :return: ``[B, N]`` (or ``[B, N, W]``) float32.
    """
    b, t = table.shape[:2]
    if b * t >= 2 ** 31:
        raise ValueError(f"{b} x {t} rows overflow the int32 row index")
    rows = table.reshape(b * t, -1).float().contiguous()
    lane = torch.arange(b, dtype=torch.int32, device=idx.device)[:, None] * t
    flat = (idx.to(torch.int32).clamp(0, t - 1) + lane).reshape(-1)
    return row_gather(rows, flat).reshape(idx.shape + table.shape[2:])


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


def bilinear_sample(img, loc):
    """Bilinear sample of a single-channel image ``[B, H, W]`` at
    ``loc [B, N, 2]`` (y, x) -> ``[B, N]`` (see :func:`gather_values`)."""
    return gather_values(img[..., None], loc)[..., 0]


def get_event_flow(flow_map, event_loc):
    """Flow map ``[B, H, W, 2]`` (x, y) sampled at event locations
    -> ``[B, N, 2]`` per-event flow in (y, x) order."""
    return gather_values(flow_map, event_loc).flip(-1)


def get_interpolation(warped_loc, res: Res, round_idx: bool = False):
    """Splat taps of warped events: the four integer taps around each
    location (top-left, top-right, bottom-left, bottom-right, concatenated
    along N) with their bilinear weights, or the nearest pixel with weight
    1 when ``round_idx``. Out-of-frame taps get index 0 and weight 0.

    :param warped_loc: ``[B, N, 2]`` (y, x).
    :return: ``(flat_idx [B, M] int32 (y * W + x), weights [B, M, 1])``,
        ``M = N`` if ``round_idx`` else ``4 * N``.
    """
    if round_idx:
        idx_yx = torch.round(warped_loc)
        weights = torch.ones(warped_loc.shape[:2] + (1,),
                             dtype=warped_loc.dtype, device=warped_loc.device)
    else:
        top_y = torch.floor(warped_loc[:, :, 0:1])
        bot_y = torch.floor(warped_loc[:, :, 0:1] + 1.0)
        left_x = torch.floor(warped_loc[:, :, 1:2])
        right_x = torch.floor(warped_loc[:, :, 1:2] + 1.0)
        idx_yx = torch.cat([
            torch.cat([top_y, left_x], 2), torch.cat([top_y, right_x], 2),
            torch.cat([bot_y, left_x], 2), torch.cat([bot_y, right_x], 2),
        ], 1)
        tiled = torch.cat([warped_loc] * 4, 1)
        weights = torch.clamp(1.0 - torch.abs(tiled - idx_yx), min=0.0)

    inside = (
        (idx_yx[:, :, 0:1] >= 0) & (idx_yx[:, :, 0:1] < res[0])
        & (idx_yx[:, :, 1:2] >= 0) & (idx_yx[:, :, 1:2] < res[1])
    ).to(warped_loc.dtype)
    idx_yx = idx_yx * inside
    if round_idx:
        weights = weights * inside
    else:
        weights = torch.prod(weights, -1, keepdim=True) * inside
    flat_idx = (idx_yx[:, :, 0] * res[1] + idx_yx[:, :, 1]).to(torch.int32)
    return flat_idx, weights


def splat_channels(flat_idx, weights, res: Res):
    """Scatter-add ``weights [B, M, C]`` at row-major pixel indices
    ``flat_idx [B, M]`` -> ``[B, H*W, C]``; indices outside ``[0, H*W)``
    drop. The bilinear splat at the indices' integer (y, x) puts each
    weight on its one pixel."""
    h, w = res
    idx = flat_idx.long()
    loc = torch.stack([torch.div(idx, w, rounding_mode="floor"), idx % w],
                      -1).float()
    img = SplatBilinearFn.apply(loc, weights.float().contiguous(), (h, w))
    return img.reshape(weights.shape[0], h * w, weights.shape[-1])


def splat_bilinear(flat_idx, weights, res: Res):
    """Image ``[B, H, W, 1]`` of ``weights [B, M, 1]`` scatter-added at
    ``flat_idx [B, M]`` (:func:`splat_channels`)."""
    img = splat_channels(flat_idx, weights, res)
    return img.reshape(weights.shape[0], res[0], res[1], 1)


def splat_values(loc, values, res: Res, round_idx: bool = False):
    """Bilinear splat ``out[h, w, c] = sum_e tri(y_e - h) tri(x_e - w)
    values[e, c]`` -> ``[B, H, W, C]``. ``round_idx`` rounds the locations
    half-to-even first (no gradient through the rounding)."""
    if round_idx:
        loc = torch.round(loc).detach()
    return SplatBilinearFn.apply(loc.float().contiguous(),
                                 values.float().contiguous(), tuple(res))


def interpolate(flat_idx, weights, res: Res, polarity_mask=None):
    """Image ``[B, H, W, 1]`` of warped events from
    :func:`get_interpolation`'s taps, weights times ``polarity_mask``
    ``[B, M, 1]`` when given."""
    if polarity_mask is not None:
        weights = weights * polarity_mask
    return splat_bilinear(flat_idx, weights, res)


def iwe_from_events(warped_loc, pol_mask, res: Res, round_idx: bool = False,
                    extra_weights=None):
    """Per-polarity image of warped events ``[B, H, W, 2]``."""
    vals = pol_mask if extra_weights is None else pol_mask * extra_weights
    return splat_values(warped_loc, vals, res, round_idx=round_idx)


def _deblur(flow_map, event_list, res: Res, masks, round_idx: bool,
            round_flow: bool):
    """Warp every event to ``tref = 1`` with the flow at its own location
    and splat ``feasible * masks [B, N, C]`` -> ``[B, H, W, C]``. The flow
    lookup is the nearest pixel (truncated index, one row gather of both
    flow channels) if ``round_flow``, bilinear otherwise."""
    loc = event_list[:, :, 1:3]
    feas = (
        (loc[:, :, 0:1] >= 0) & (loc[:, :, 0:1] < res[0])
        & (loc[:, :, 1:2] >= 0) & (loc[:, :, 1:2] < res[1])
    ).to(loc.dtype)
    loc = loc * feas
    if round_flow:
        flat = (loc[:, :, 0] * res[1] + loc[:, :, 1]).to(torch.int32)
        fmap = flow_map.reshape(flow_map.shape[0], -1, 2)
        event_flow = gather_pixels(fmap, flat).flip(-1)  # (x, y) -> (y, x)
    else:
        event_flow = get_event_flow(flow_map, loc)
    fw = event_propagation(event_list[:, :, 0:1], loc, event_flow, 1.0)
    return splat_values(fw, feas * masks, res, round_idx=round_idx)


def deblur_events(flow_map, event_list, res: Res, round_idx: bool = True,
                  polarity_mask=None, round_flow: bool = True):
    """Motion-compensated image ``[B, H, W, 1]`` of one polarity
    (reference ``utils/iwe.py:139-224``).

    :param flow_map: ``[B, H, W, 2]`` (x, y).
    :param event_list: ``[B, N, 4]`` (ts, y, x, p), ts in ``[0, 1]``.
    :param polarity_mask: optional ``[B, N, 1]``.
    """
    if polarity_mask is None:
        polarity_mask = torch.ones_like(event_list[:, :, :1])
    return _deblur(flow_map, event_list, res, polarity_mask, round_idx,
                   round_flow)


def compute_pol_iwe(flow_map, event_list, res: Res, pol_mask,
                    round_idx: bool = True, round_flow: bool = True):
    """Per-polarity image of warped events ``[B, H, W, 2]`` (reference
    ``utils/iwe.py:227-257``): both polarities of :func:`deblur_events`
    from one flow lookup and one two-channel splat."""
    return _deblur(flow_map, event_list, res, pol_mask, round_idx,
                   round_flow)

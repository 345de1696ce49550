"""Event -> image encodings: the PyTorch counterpart of
``taming_event_flow_tpu/ops/encodings.py`` (plain ``index_add_``).
"""

from __future__ import annotations

from typing import Tuple

import torch


def events_to_image(xs, ys, ps, sensor_size: Tuple[int, int], valid=None):
    """Scatter-add per-event values into an ``[H, W]`` image.

    :param xs, ys: ``[N]`` integer-valued coordinates (truncated, clipped).
    :param ps: ``[N]`` values; ``valid`` an optional ``[N]`` mask.
    """
    h, w = sensor_size
    xi = xs.to(torch.int64).clamp(0, w - 1)
    yi = ys.to(torch.int64).clamp(0, h - 1)
    vals = ps if valid is None else ps * valid.to(ps.dtype)
    img = torch.zeros(h * w, dtype=vals.dtype, device=vals.device)
    img.index_add_(0, yi * w + xi, vals)
    return img.reshape(h, w)


def events_to_channels(xs, ys, ps, sensor_size: Tuple[int, int], valid=None):
    """Per-polarity count image ``[H, W, 2]``: positive events in channel 0,
    negative in channel 1, both as positive counts."""
    pos = torch.where(ps > 0, ps, 0.0)
    neg = torch.where(ps < 0, -ps, 0.0)
    return torch.stack(
        [events_to_image(xs, ys, pos, sensor_size, valid),
         events_to_image(xs, ys, neg, sensor_size, valid)], dim=-1)


def derive_count_input(event_list, res: Tuple[int, int]):
    """The count network input, built on the device from the event list —
    element for element the host loader's ``events_to_channels`` for
    integer coordinates.

    :param event_list: ``[..., N, 4]`` (ts, y, x, p); padding rows carry
        ``p == 0`` and contribute nothing.
    :return: ``[..., H, W, 2]`` float32 per-polarity counts.
    """
    h, w = res
    hw = h * w
    lead = event_list.shape[:-2]
    n = event_list.shape[-2]
    ys, xs, ps = event_list[..., 1], event_list[..., 2], event_list[..., 3]
    xi = xs.to(torch.int64).clamp(0, w - 1)
    yi = ys.to(torch.int64).clamp(0, h - 1)
    # one scatter over a polarity-offset flat index: positive events land
    # in plane 0, negative in plane 1, each lane in its own 2*H*W block
    idx = (yi * w + xi + torch.where(ps < 0, hw, 0)).reshape(-1, n)
    lanes = idx.shape[0]
    idx = idx + (torch.arange(lanes, device=idx.device) * (2 * hw))[:, None]
    img = torch.zeros(lanes * 2 * hw, dtype=torch.float32,
                      device=event_list.device)
    img.index_add_(0, idx.reshape(-1), ps.abs().reshape(-1).float())
    return img.reshape(lanes, 2, h, w).movedim(1, -1).reshape(
        *lead, h, w, 2)

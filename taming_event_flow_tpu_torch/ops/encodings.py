"""Event -> image encodings: the PyTorch counterpart of
``taming_event_flow_tpu/ops/encodings.py`` (plain ``index_add_``, where the
JAX package has XLA's scatter; the rectification remap of the count input
is the row gather kernel).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .cuda_warp import row_gather


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


def events_to_voxel(xs, ys, ts, ps, num_bins: int,
                    sensor_size: Tuple[int, int], valid=None):
    """Voxel grid ``[H, W, num_bins]`` by temporal bilinear interpolation:
    event ``e`` adds ``p_e * max(0, 1 - |t_e * (num_bins - 1) - b|)`` to bin
    ``b`` at its pixel (reference ``dataloader/encodings.py:32-56``), all
    bins in one ``index_add_``.

    :param xs, ys: ``[N]`` integer-valued coordinates (truncated, clipped).
    :param ts: ``[N]`` timestamps normalised to ``[0, 1]``.
    :param ps: ``[N]`` values; ``valid`` an optional ``[N]`` mask.
    """
    h, w = sensor_size
    bins = torch.arange(num_bins, dtype=ts.dtype, device=ts.device)
    weights = torch.clamp(
        1.0 - torch.abs(ts[:, None] * (num_bins - 1) - bins), min=0.0)
    vals = ps[:, None] * weights
    if valid is not None:
        vals = vals * valid.to(vals.dtype)[:, None]
    xi = xs.to(torch.int64).clamp(0, w - 1)
    yi = ys.to(torch.int64).clamp(0, h - 1)
    img = torch.zeros(h * w, num_bins, dtype=vals.dtype, device=vals.device)
    img.index_add_(0, yi * w + xi, vals)
    return img.reshape(h, w, num_bins)


def derive_count_input(event_list, res: Tuple[int, int], raw_xy=None,
                       remap_idx=None):
    """The count network input, built on the device from the event list —
    element for element the host loader's construction
    (``events_to_channels_np`` at the raw coordinates, then the
    nearest-neighbour rectification ``remap``) for integer coordinates.

    :param event_list: ``[..., N, 4]`` (ts, y, x, p); padding rows carry
        ``p == 0`` and contribute nothing.
    :param raw_xy: optional ``[..., N, 2]`` (y, x) raw (pre-rectification)
        integer coordinates, used instead of the list's own (y, x) when the
        list carries rectified fractional ones.
    :param remap_idx: optional ``[H, W]`` or ``[B, H, W]`` integer
        backward-rectification index, 1-based, ``0`` marking out-of-source
        pixels (``data.base.remap_index``), broadcast over the leading
        (pass) axes: output pixel ``i`` takes the counts of pixel
        ``remap_idx[i] - 1``, or zero. One row gather of the ``[H*W, 2]``
        count rows; exact, since the counts are integers and the gather
        copies them.
    :return: ``[..., H, W, 2]`` float32 per-polarity counts.
    """
    h, w = res
    hw = h * w
    lead = event_list.shape[:-2]
    n = event_list.shape[-2]
    coords = event_list[..., 1:3] if raw_xy is None else raw_xy.float()
    ys, xs, ps = coords[..., 0], coords[..., 1], event_list[..., 3]
    xi = xs.to(torch.int64).clamp(0, w - 1)
    yi = ys.to(torch.int64).clamp(0, h - 1)
    # one scatter into per-lane [rows, 2] count rows: positive events land
    # in column 0, negative in column 1; with a remap, each lane has one
    # more row, left at zero, for the out-of-source pixels to read
    rows = hw + (remap_idx is not None)
    idx = ((yi * w + xi) * 2 + (ps < 0)).reshape(-1, n)
    lanes = idx.shape[0]
    idx = idx + (torch.arange(lanes, device=idx.device) * (2 * rows))[:, None]
    img = torch.zeros(lanes * rows * 2, dtype=torch.float32,
                      device=event_list.device)
    img.index_add_(0, idx.reshape(-1), ps.abs().reshape(-1).float())
    if remap_idx is None:
        return img.reshape(*lead, h, w, 2)
    if lanes * rows >= 2 ** 31:
        raise ValueError(f"{lanes} x {rows} count rows overflow int32")
    src = remap_idx.reshape(remap_idx.shape[:-2] + (h, w)).expand(
        *lead, h, w).reshape(lanes, hw)
    src = torch.where((src > 0) & (src <= hw), src - 1, hw).to(torch.int32)
    src = src + (torch.arange(lanes, dtype=torch.int32, device=src.device)
                 * rows)[:, None]
    out = row_gather(img.view(lanes * rows, 2), src.reshape(-1))
    return out.reshape(*lead, h, w, 2)

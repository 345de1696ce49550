"""Event -> image encodings and the u32 event wire: the PyTorch counterpart
of ``taming_event_flow_tpu/ops/encodings.py`` (plain ``index_add_``, where
the JAX package has XLA's scatter; the rectification remap of the count
input and the wire's rectified-coordinate lookup are the row gather
kernel).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
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


def pack_event_wire_np(ys, xs, ps):
    """Host-side u32 packing of integer event coordinates and polarity:
    ``y << 16 | x << 2 | pcode``, ``pcode`` 1 for positive, 2 for negative,
    0 for padding rows (``p == 0``). Exact for integer ``y < 65536`` and
    ``x < 16384``; one u32 replaces the y, x and p floats of an event.

    :param ys, xs: integer-valued arrays (any float or int dtype).
    :param ps: polarity +-1 (0 for padding).
    :return: uint32 array of ``ys.shape``.
    """
    pcode = np.where(ps > 0, 1, 0) + np.where(ps < 0, 2, 0)
    return ((ys.astype(np.uint32) << 16) | (xs.astype(np.uint32) << 2)
            | pcode.astype(np.uint32))


def unpack_event_wire(ts, yxp, rect=None):
    """The device twin of :func:`pack_event_wire_np`: rebuild the
    ``[..., N, 4]`` (ts, y, x, p) event list and the raw integer
    coordinates.

    :param ts: ``[..., N]`` float32 window-normalised timestamps.
    :param yxp: ``[..., N]`` packed words, uint32 or int32 (the same bits:
        torch's uint32 has no shifts, so the words are read as int32).
    :param rect: optional ``[H, W, 2]`` float32 forward rectification map
        in the file's layout, ``rect[y_raw, x_raw] = (x_rect, y_rect)``
        (x first). When given, the event list carries the rectified
        coordinates, looked up by one row gather of the ``[H*W, 2]`` table
        (:func:`..cuda_warp.row_gather`: the kernel for a CUDA tensor):
        bitwise the host's lookup, which reads the same float32 table.
    :return: ``(event_list [..., N, 4], raw_yx [..., N, 2] float32)``, the
        latter :func:`derive_count_input`'s ``raw_xy``.
    """
    words = yxp.view(torch.int32) if yxp.dtype == torch.uint32 else yxp
    yi = (words >> 16) & 0xFFFF
    xi = (words >> 2) & 0x3FFF
    pcode = words & 3
    p = (pcode == 1).float() - (pcode == 2).float()
    y, x = yi.float(), xi.float()
    raw_yx = torch.stack([y, x], dim=-1)
    if rect is not None:
        h, w = rect.shape[0], rect.shape[1]
        idx = (yi * w + xi).reshape(-1).to(torch.int32)
        looked = row_gather(rect.reshape(h * w, 2), idx).reshape(
            yxp.shape + (2,))
        y, x = looked[..., 1], looked[..., 0]  # the file's layout is (x, y)
    return torch.stack([ts, y, x, p], dim=-1), raw_yx

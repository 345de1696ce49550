"""Host-side numpy helpers of the loader: the port's own copies of the
count encoding and the rectification steps of
``taming_event_flow_tpu/data/base.py`` (``events_to_channels_np`` and the
``BaseStreamLoader`` methods ``rectify_events``, ``remap`` and
``remap_index``), as plain functions of the resolution.

Only numpy: the nearest-neighbour ``remap`` keeps the numpy path of the
JAX loader and never calls cv2.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

Res = Tuple[int, int]  # (H, W)


def events_to_channels_np(xs, ys, ps, res: Res):
    """``[H, W, 2]`` float32 per-polarity counts: positive events in
    channel 0 with weight ``ps``, negative in channel 1 with weight
    ``-ps``, zeros (padding) contribute nothing. One bincount over a
    polarity-offset index."""
    hw = res[0] * res[1]
    idx = ys.astype(np.int64) * res[1] + xs.astype(np.int64)
    idx += hw * (ps < 0)
    img = np.bincount(idx, weights=np.abs(ps), minlength=2 * hw)
    return np.transpose(
        img.reshape(2, res[0], res[1]), (1, 2, 0)
    ).astype(np.float32)


def rectify_events(rectify_map, xs, ys):
    """Per-event rectified coordinates from the file's forward lookup map
    ``rectify_map[y_raw, x_raw] = (x_rect, y_rect)`` (reference
    ``dataloader/base.py:173-188``). Returns float32 ``(xs, ys)``."""
    rect = rectify_map[ys.astype(np.int64), xs.astype(np.int64)]
    return rect[:, 0].astype(np.float32), rect[:, 1].astype(np.float32)


def remap(img_hwc, mapping, res: Res):
    """Backward-rectify an image-like ``[H, W, ...]`` array by nearest
    lookup: output pixel ``(y, x)`` reads ``img[rint(mapping[y, x, 1]),
    rint(mapping[y, x, 0])]`` (reference ``dataloader/base.py:290-298``).

    This is the numpy path of the JAX loader. It clips a source outside the
    frame to the border, where cv2's ``remap`` fills 0; so a
    :func:`remap_index` built here has no ``0`` entries, and the ``0``
    (out-of-source) entries that a cv2-built index carries are made by
    hand in the tests.
    """
    if mapping is None:
        return img_hwc
    mx = np.clip(np.rint(mapping[..., 0]), 0, res[1] - 1).astype(int)
    my = np.clip(np.rint(mapping[..., 1]), 0, res[0] - 1).astype(int)
    return img_hwc[my, mx]


def remap_index(mapping, res: Res) -> Optional[np.ndarray]:
    """:func:`remap`'s pixel lookup as a gather index: an index image
    remapped through the same path, ``[H, W]`` int32, 1-based (``0``
    marks an out-of-source pixel), or ``None`` without a mapping. A device
    gather with it (``ops.derive_count_input``) is element for element the
    host remap of any image."""
    if mapping is None:
        return None
    h, w = res
    idx_img = np.arange(1, h * w + 1, dtype=np.float32).reshape(h, w)
    return remap(idx_img, mapping, res).astype(np.int32)

"""Shared loss machinery: the PyTorch counterpart of
``taming_event_flow_tpu/objectives/base.py`` (config, fused IWE+timestamp
splat, focus loss, flow smoothness priors).

Flow-map sequences are ``[B, P, H, W, 2]`` stacks per scale (last dim
``(x, y)``), events ``(ts, y, x, p)``, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..ops import get_event_flow, splat_values


class LossConfig(NamedTuple):
    """Static loss hyperparameters (reference ``configs/train_flow.yml``),
    with the JAX package's fields and defaults.

    ``passes_loss`` is the *effective* window length: callers have already
    doubled it for ``iterative_mode == "four"``.

    Of the JAX package's performance knobs the port runs the defaults:
    ``triangular_warp=True``, ``batched_sweep=False`` and
    ``warp_remat=False``; :func:`..iterative.iterative_loss` raises for the
    others (queued in ROADMAP.md). ``scan_unroll`` tunes XLA's scans and has
    no effect here: the port's passes and warp steps are Python loops.
    """

    res: Tuple[int, int]
    passes_loss: int = 10
    scales_loss: int = 1
    iterative_mode: str = "two"  # one / two / four
    round_ts: bool = False
    loss_scaling: bool = True
    border_compensation: bool = True
    flow_spat_smooth_weight: Optional[float] = None
    flow_temp_smooth_weight: Optional[float] = None
    warp_remat: bool = False
    scan_unroll: int = 1
    batched_sweep: bool = False
    triangular_warp: bool = True

    @property
    def passes_list(self) -> Sequence[int]:
        # timescales: passes_loss / 2^s (reference ``loss/flow.py:41-44``)
        return [self.passes_loss // (2**s) for s in range(self.scales_loss)]

    @property
    def delta_passes(self) -> Sequence[int]:
        # deblurring-window radius per timescale (reference
        # ``loss/flow.py:434-441``)
        div = {"one": 1, "two": 2, "four": 4}[self.iterative_mode]
        return [p // div for p in self.passes_list]


def global_ts(event_ts, pass_idx, round_ts: bool):
    """Window-local ts in [0, 1] -> global pass timeline ts in [t, t+1].

    ``round_ts`` collapses every event of a pass to ``min(ts) + 0.5``
    (reference ``loss/flow.py:461-463``).

    :param event_ts: ``[P, B, N, 1]`` window-local timestamps.
    :param pass_idx: ``[P, 1, 1, 1]`` pass indices.
    """
    ts = event_ts + pass_idx
    if round_ts:
        # unmasked min is exact: the loader pins the first real event of
        # every non-empty window to ts 0, the value padding rows carry
        mins = torch.amin(ts, dim=(1, 2, 3), keepdim=True)
        ts = (mins + 0.5).expand_as(ts)
    return ts


def iwe_with_ts(warped_loc, pol_mask, norm_ts, res):
    """Per-polarity IWE and timestamp-IWE in ONE 4-channel splat
    (pos, neg, pos*ts, neg*ts).

    :param warped_loc: ``[B, N, 2]`` warped ``(y, x)`` locations.
    :param pol_mask: ``[B, N, 2]`` polarity mask (zero for padding).
    :param norm_ts: ``[B, N, 1]`` normalized timestamps.
    :return: ``(iwe, iwe_ts)`` each ``[B, H, W, 2]``.
    """
    vals = torch.cat([pol_mask, pol_mask * norm_ts], dim=-1)  # [B, N, 4]
    buf = splat_values(warped_loc, vals, res)
    return buf[..., 0:2], buf[..., 2:4]


def focus_loss(iwe, iwe_ts_norm, loss_scaling: bool = True):
    """Squared average-timestamp focus objective (reference
    ``loss/flow.py:112-129``), summed over the batch.

    :param iwe: ``[B, H, W, 2]`` image of warped events.
    :param iwe_ts_norm: ``[B, H, W, 2]`` per-pixel/per-polarity average ts.
    """
    b = iwe.shape[0]
    ts_flat = iwe_ts_norm.reshape(b, -1, 2)
    loss = (ts_flat[..., 0] ** 2).sum(1) + (ts_flat[..., 1] ** 2).sum(1)
    if loss_scaling:
        nonzero_px = (iwe.sum(-1) > 0).reshape(b, -1)
        loss = loss / (nonzero_px.sum(1) + 1e-9)
    return loss.sum()


def _charb(a):
    return torch.sqrt(a**2 + 1e-6)


def flow_spatial_smoothing(flow_seq_per_scale, weight: float):
    """Charbonnier spatial smoothness over 4 directions (reference
    ``loss/flow.py:170-209``).

    :param flow_seq_per_scale: list over scales of ``[B, P, H, W, 2]``.
    """
    total = 0.0
    for flow in flow_seq_per_scale:
        fx, fy = flow[..., 0], flow[..., 1]  # [B, P, H, W]
        d_x = (_charb(fx[..., :, :-1] - fx[..., :, 1:])
               + _charb(fy[..., :, :-1] - fy[..., :, 1:]))
        d_y = (_charb(fx[..., :-1, :] - fx[..., 1:, :])
               + _charb(fy[..., :-1, :] - fy[..., 1:, :]))
        d_dr = (_charb(fx[..., :-1, :-1] - fx[..., 1:, 1:])
                + _charb(fy[..., :-1, :-1] - fy[..., 1:, 1:]))
        d_ur = (_charb(fx[..., 1:, :-1] - fx[..., :-1, 1:])
                + _charb(fy[..., 1:, :-1] - fy[..., :-1, 1:]))
        b, p = flow.shape[0], flow.shape[1]
        acc = 0.0
        for t in (d_x, d_y, d_dr, d_ur):
            acc = acc + t.reshape(b, p, -1).mean(2).mean(1)
        total = total + acc / 4.0
    total = total / len(flow_seq_per_scale)
    return weight * total.sum()


def flow_temporal_smoothing(flow_seq_per_scale, res, weight: float):
    """Charbonnier temporal consistency against the backward-warped next
    flow map (reference ``loss/flow.py:131-168``).

    :param flow_seq_per_scale: list over scales of ``[B, P, H, W, 2]``.
    """
    h, w = res
    dev = flow_seq_per_scale[0].device
    flat = torch.arange(h * w, device=dev)[None]
    grid = torch.stack([(flat // w).float(), (flat % w).float()],
                       dim=-1)  # [1, HW, 2] (y, x)

    total = 0.0
    num_passes = flow_seq_per_scale[0].shape[1]
    for flow in flow_seq_per_scale:
        b = flow.shape[0]
        acc = 0.0
        for j in range(num_passes - 1):
            fj = flow[:, j]  # [B, H, W, 2] (x, y)
            flow_yx = torch.stack([fj[..., 1].reshape(b, -1),
                                   fj[..., 0].reshape(b, -1)], dim=-1)
            warped_idx = grid + flow_yx  # [B, HW, 2]
            inside = ((warped_idx[..., 0] >= 0)
                      & (warped_idx[..., 0] <= h - 1.0)
                      & (warped_idx[..., 1] >= 0)
                      & (warped_idx[..., 1] <= w - 1.0)).to(flow.dtype)
            warped_flow = get_event_flow(flow[:, j + 1], warped_idx)
            diff = torch.sqrt((flow_yx - warped_flow) ** 2 + 1e-9).sum(-1)
            acc = acc + (diff * inside).sum(1) / (inside.sum(1) + 1e-9)
        total = total + acc
    total = total / len(flow_seq_per_scale)
    total = total / (num_passes - 1)
    return weight * total.sum()

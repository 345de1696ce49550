"""Linear (single-warp) contrast-maximization loss: the PyTorch counterpart
of ``taming_event_flow_tpu/objectives/linear.py`` (the NeurIPS'21 scheme,
reference ``loss/flow.py:216-412``).

Each event samples the flow map of its *arrival* pass once, and every
window is warped in one shot to its extremes: forward to ``high_pass`` and
backward to ``low_pass``. As in :mod:`.iterative`, grad and detached events
share one tensor with a per-event ``grad_mask``.
"""

from __future__ import annotations

import torch

from ..ops import event_propagation, get_event_flow, purge_unfeasible
from ..parallel.collectives import pmean
from .base import (
    LossConfig,
    flow_spatial_smoothing,
    flow_temporal_smoothing,
    focus_loss,
    global_ts,
    iwe_with_ts,
)


def _arrival_flow(flow_maps, loc):
    """Each pass's flow map sampled at its own events, in one gather over
    the ``P * B`` (map, events) pairs.

    :param flow_maps: ``[P, B, H, W, 2]``.
    :param loc: ``[P, B, N, 2]``.
    :return: ``[P, B, N, 2]`` per-event flow ``(y, x)``.
    """
    p, b, h, w, _ = flow_maps.shape
    flow = get_event_flow(flow_maps.reshape(p * b, h, w, 2),
                          loc.reshape(p * b, -1, 2))
    return flow.reshape(loc.shape)


def linear_loss(flows, event_list, pol_mask, grad_mask, cfg: LossConfig,
                event_axis=None):
    """Linear contrast-max training loss (reference ``loss/flow.py:
    306-412``).

    :param flows: ``[P, S, B, H, W, 2]`` multi-scale flow sequence.
    :param event_list: ``[P, B, N, 4]`` events ``(ts, y, x, p)``, ts in
        ``[0, 1]`` per window; zero-padded.
    :param pol_mask: ``[P, B, N, 2]``.
    :param grad_mask: ``[P, B, N, 1]`` (1 = gradient-path event), or
        ``None``.
    :param event_axis: optional process group the event dimension is
        sharded over (see :func:`..iterative.iterative_loss`).
    :return: scalar loss.
    """
    p, s_scales = flows.shape[0], flows.shape[1]
    if p != cfg.passes_loss:
        raise ValueError(f"flows hold {p} passes, the config "
                         f"{cfg.passes_loss}")

    pass_ids = torch.arange(p, dtype=event_list.dtype,
                            device=event_list.device).reshape(p, 1, 1, 1)
    ts = global_ts(event_list[..., 0:1], pass_ids, cfg.round_ts)
    loc = event_list[..., 1:3]
    b, n = loc.shape[1], loc.shape[2]

    loss = 0.0
    for i in range(s_scales):
        event_flow = _arrival_flow(flows[:, i], loc)
        for s, scale in enumerate(cfg.passes_list):
            loss_update = 0.0
            for w in range(2**s):
                low_pass = w * scale
                high_pass = (w + 1) * scale
                k = high_pass - low_pass

                def flat(x):
                    return x[low_pass:high_pass].permute(1, 0, 2, 3).reshape(
                        b, k * n, x.shape[-1])

                w_ts, w_loc = flat(ts), flat(loc)
                w_flow, w_mask = flat(event_flow), flat(pol_mask)
                fw = event_propagation(w_ts, w_loc, w_flow, float(high_pass))
                bw = event_propagation(w_ts, w_loc, w_flow, float(low_pass))
                if cfg.border_compensation:
                    # sequential purge: the mask takes both warps' exits
                    # and both IWEs share it (reference flow.py:340-343)
                    fw, w_mask = purge_unfeasible(fw, w_mask, cfg.res)
                    bw, w_mask = purge_unfeasible(bw, w_mask, cfg.res)
                if grad_mask is not None:
                    gm = flat(grad_mask) > 0
                    fw = torch.where(gm, fw, fw.detach())
                    bw = torch.where(gm, bw, bw.detach())

                fw_ts = 1.0 - torch.abs(high_pass - w_ts) / scale
                bw_ts = 1.0 - torch.abs(low_pass - w_ts) / scale
                for warped, norm_ts in ((fw, fw_ts), (bw, bw_ts)):
                    iwe, iwe_ts = iwe_with_ts(warped, w_mask, norm_ts,
                                              cfg.res, event_axis)
                    loss_update = loss_update + focus_loss(
                        iwe, iwe_ts / (iwe + 1e-9), cfg.loss_scaling)
            loss_update = loss_update / (2**s)
            loss_update = loss_update / 2  # fw + bw deblurring points
            loss = loss + loss_update

    loss = loss / cfg.scales_loss
    loss = loss / s_scales

    flow_seq = [flows[:, i].permute(1, 0, 2, 3, 4) for i in range(s_scales)]
    if cfg.flow_spat_smooth_weight is not None:
        loss = loss + flow_spatial_smoothing(flow_seq,
                                             cfg.flow_spat_smooth_weight)
    if cfg.flow_temp_smooth_weight is not None and p > 1:
        loss = loss + flow_temporal_smoothing(flow_seq, cfg.res,
                                              cfg.flow_temp_smooth_weight)
    if event_axis is not None:
        loss = pmean(loss, event_axis)
    return loss

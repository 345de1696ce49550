"""Iterative multi-reference contrast-maximization loss: the PyTorch
counterpart of ``taming_event_flow_tpu/objectives/iterative.py``
(reference ``loss/flow.py:415-746``).

The port runs the JAX package's default formulation: the triangular warp
table (per timeline step, only the windows that have joined are warped)
and the looped per-tref deblurring sweep, one 4-channel IWE splat per tref.
Grad and detached events share one tensor with a per-event ``grad_mask``:
recorded table locations pass through ``where(grad_mask > 0, loc,
loc.detach())``, and every mask the warp produces is detached, so gradients
flow exactly where the JAX package's do. Padding events carry zero polarity
masks and drop out of every IWE.

Inputs use the global convention: ``flows[p, s]`` is the scale-``s`` flow
map (already ``flow_scaling``-scaled, in px/pass) predicted at pass ``p``.
"""

from __future__ import annotations

import torch

from ..ops import get_event_flow, purge_unfeasible
from .base import (
    LossConfig,
    flow_spatial_smoothing,
    flow_temporal_smoothing,
    focus_loss,
    global_ts,
    iwe_with_ts,
)


def _sample_all(flow_map, loc):
    """Sample one flow map at the locations of several event windows.

    :param flow_map: ``[B, H, W, 2]``.
    :param loc: ``[K, B, N, 2]``.
    :return: ``[K, B, N, 2]`` per-event flow ``(y, x)``.
    """
    k, b, n, _ = loc.shape
    loc_b = loc.permute(1, 0, 2, 3).reshape(b, k * n, 2)
    flow = get_event_flow(flow_map, loc_b)
    return flow.reshape(b, k, n, 2).permute(1, 0, 2, 3)


def _gate(loc, gm):
    # the reference's detached-event path: no gradient where grad_mask == 0
    if gm is None:
        return loc
    return torch.where(gm > 0, loc, loc.detach())


def _step(flow_map, loc, ts, mask, tref, res):
    flow = _sample_all(flow_map, loc)
    prop = loc + (tref - ts) * flow
    prop, mask = purge_unfeasible(prop, mask, res)
    return prop, mask.detach()


def warp_table_triangular(flow_maps, event_loc, event_ts, pol_mask, res,
                          grad_mask=None):
    """The (tref x window) iterative warp table, built with ragged per-step
    slices: the forward direction carries exactly the ``tau + 1`` windows
    that have joined, the backward one the ``P - tau`` remaining ones, and
    the two halves assemble as ``table[tref] = concat(fw[:tref],
    bw[tref:])``.

    :param flow_maps: ``[P, B, H, W, 2]`` flow sequence for one scale.
    :param event_loc: ``[P, B, N, 2]`` per-window event ``(y, x)``.
    :param event_ts: ``[P, B, N, 1]`` global timeline ts (in ``[t, t+1]``).
    :param pol_mask: ``[P, B, N, 2]`` polarity masks.
    :param grad_mask: optional ``[P, B, N, 1]``; recorded locations of
        events with ``grad_mask == 0`` carry no gradient.
    :return: ``(table_loc, table_mask)`` of shape ``[P+1, P, B, N, 2]``:
        entry ``[tref, t]`` holds window ``t``'s events warped to time
        ``tref`` and the polarity mask after cumulative purging.
    """
    p = flow_maps.shape[0]

    # forward: windows join at their own pass and ride to the end
    fw_tab = []  # fw_tab[tau] = (loc, mask) of windows [0 : tau+1] at tau+1
    cur_loc, cur_ts, cur_mask = event_loc[0:1], event_ts[0:1], pol_mask[0:1]
    for tau in range(p):
        if tau > 0:
            cur_loc = torch.cat([cur_loc, event_loc[tau:tau + 1]])
            cur_ts = torch.cat([cur_ts, event_ts[tau:tau + 1]])
            cur_mask = torch.cat([cur_mask, pol_mask[tau:tau + 1]])
        prop, cur_mask = _step(flow_maps[tau], cur_loc, cur_ts, cur_mask,
                               tau + 1.0, res)
        gm = None if grad_mask is None else grad_mask[: tau + 1]
        fw_tab.append((_gate(prop, gm), cur_mask))
        cur_loc = prop
        cur_ts = torch.full_like(cur_ts, tau + 1.0)

    # backward: windows join as the timeline walks back past them
    bw_tab = [None] * p  # bw_tab[tau] = (loc, mask) of windows [tau : P]
    cur_loc, cur_ts = event_loc[p - 1:], event_ts[p - 1:]
    cur_mask = pol_mask[p - 1:]
    for tau in range(p - 1, -1, -1):
        if tau < p - 1:
            cur_loc = torch.cat([event_loc[tau:tau + 1], cur_loc])
            cur_ts = torch.cat([event_ts[tau:tau + 1], cur_ts])
            cur_mask = torch.cat([pol_mask[tau:tau + 1], cur_mask])
        prop, cur_mask = _step(flow_maps[tau], cur_loc, cur_ts, cur_mask,
                               float(tau), res)
        gm = None if grad_mask is None else grad_mask[tau:]
        bw_tab[tau] = (_gate(prop, gm), cur_mask)
        cur_loc = prop
        cur_ts = torch.full_like(cur_ts, float(tau))

    # assemble: the ragged pieces are exactly complementary
    table_loc, table_mask = [bw_tab[0][0]], [bw_tab[0][1]]
    for tref in range(1, p):
        table_loc.append(torch.cat([fw_tab[tref - 1][0][:tref],
                                    bw_tab[tref][0]]))
        table_mask.append(torch.cat([fw_tab[tref - 1][1][:tref],
                                     bw_tab[tref][1]]))
    table_loc.append(fw_tab[p - 1][0])
    table_mask.append(fw_tab[p - 1][1])
    return torch.stack(table_loc), torch.stack(table_mask)


def _unported(cfg: LossConfig, event_axis):
    for flag, what in ((not cfg.triangular_warp,
                        "triangular_warp=False (the scan warp table)"),
                       (cfg.batched_sweep, "batched_sweep=True"),
                       (cfg.warp_remat, "warp_remat=True"),
                       (event_axis is not None, "event_axis (event mesh)")):
        if flag:
            raise NotImplementedError(
                f"iterative_loss: {what} is not ported yet; see ROADMAP.md")


def iterative_loss(flows, event_list, pol_mask, grad_mask, cfg: LossConfig,
                   event_axis=None):
    """Full Iterative contrast-max training loss (reference
    ``loss/flow.py:588-746``).

    :param flows: ``[P, S, B, H, W, 2]`` multi-scale flow sequence (already
        upsampled to full res and flow_scaling-scaled).
    :param event_list: ``[P, B, N, 4]`` events ``(ts, y, x, p)``, ts in
        ``[0, 1]`` per window; zero-padded.
    :param pol_mask: ``[P, B, N, 2]``.
    :param grad_mask: ``[P, B, N, 1]`` (1 = gradient-path event).
    :param event_axis: not ported (the JAX package's event mesh); raises.
    :return: scalar loss.
    """
    _unported(cfg, event_axis)
    p, s_scales = flows.shape[0], flows.shape[1]
    if p != cfg.passes_loss:
        raise ValueError(f"flows hold {p} passes, the config "
                         f"{cfg.passes_loss}")

    pass_ids = torch.arange(p, dtype=event_list.dtype,
                            device=event_list.device).reshape(p, 1, 1, 1)
    ts = global_ts(event_list[..., 0:1], pass_ids, cfg.round_ts)
    loc = event_list[..., 1:3]

    def scale_loss(flow_maps):
        tbl_loc, tbl_mask = warp_table_triangular(
            flow_maps, loc, ts, pol_mask, cfg.res, grad_mask=grad_mask)
        loss = 0.0
        for s, scale in enumerate(cfg.passes_list):
            delta = cfg.delta_passes[s]
            loss_update = 0.0
            for w in range(2**s):
                low_pass = w * scale
                high_pass = (w + 1) * scale
                low_tref, high_tref = low_pass, high_pass + 1
                if cfg.iterative_mode == "four":
                    low_tref = low_pass + delta
                    high_tref = low_pass + 3 * delta + 1
                if cfg.border_compensation:
                    # events leaving the frame at ANY tref of the window are
                    # excluded everywhere (reference ``loss/flow.py:671-681``)
                    shared_mask = torch.prod(tbl_mask[low_tref:high_tref],
                                             dim=0)  # [P, B, N, 2]
                for tref in range(low_tref, high_tref):
                    low_ext = max(low_pass, tref - delta)
                    high_ext = min(high_pass, tref + delta)
                    k = high_ext - low_ext
                    wl = tbl_loc[tref, low_ext:high_ext]  # [K, B, N, 2]
                    if cfg.border_compensation:
                        wm = shared_mask[low_ext:high_ext]
                    else:
                        wm = tbl_mask[tref, low_ext:high_ext]
                    wts = ts[low_ext:high_ext]
                    b, n = wl.shape[1], wl.shape[2]

                    def flat(x):
                        return x.permute(1, 0, 2, 3).reshape(
                            b, k * n, x.shape[-1])

                    norm_ts = 1.0 - torch.abs(tref - flat(wts)) / delta
                    iwe, iwe_ts = iwe_with_ts(flat(wl), flat(wm), norm_ts,
                                              cfg.res)
                    iwe_ts_norm = iwe_ts / (iwe + 1e-9)
                    loss_update = loss_update + focus_loss(
                        iwe, iwe_ts_norm, cfg.loss_scaling)
            loss_update = loss_update / (2**s)
            loss_update = loss_update / (2 * delta + 1)
            loss = loss + loss_update
        return loss

    loss = sum(scale_loss(flows[:, i]) for i in range(s_scales))
    loss = loss / cfg.scales_loss
    loss = loss / s_scales

    flow_seq = [flows[:, i].permute(1, 0, 2, 3, 4) for i in range(s_scales)]
    if cfg.flow_spat_smooth_weight is not None:
        loss = loss + flow_spatial_smoothing(flow_seq,
                                             cfg.flow_spat_smooth_weight)
    if cfg.flow_temp_smooth_weight is not None and p > 1:
        loss = loss + flow_temporal_smoothing(flow_seq, cfg.res,
                                              cfg.flow_temp_smooth_weight)
    return loss

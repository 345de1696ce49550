"""The Iterative and the Linear contrast-maximisation losses, plain.

Frozen copy of ``taming_event_flow_tpu_torch/objectives/base.py``
(``global_ts``, ``iwe_with_ts``, ``focus_loss``), ``objectives/
iterative.py`` (``warp_table_triangular`` and the looped deblurring sweep
of ``iterative_loss``) and ``objectives/linear.py`` (``linear_loss``) at
commit 96ab861, for the options the benchmark's configurations state:
border compensation and loss scaling on, ``round_ts`` off, no smoothness
terms, one process (no event axis). Departures: the splat and the gather
are :mod:`.warp`'s.
"""

from __future__ import annotations

import torch

from .warp import event_flow, purge, splat


def iwe_with_ts(loc, pol_mask, norm_ts, res):
    buf = splat(loc, torch.cat([pol_mask, pol_mask * norm_ts], dim=-1), res)
    return buf[..., 0:2], buf[..., 2:4]


def focus_loss(iwe, iwe_ts_norm):
    b = iwe.shape[0]
    ts_flat = iwe_ts_norm.reshape(b, -1, 2)
    loss = (ts_flat[..., 0] ** 2).sum(1) + (ts_flat[..., 1] ** 2).sum(1)
    nonzero_px = (iwe.sum(-1) > 0).reshape(b, -1)
    return (loss / (nonzero_px.sum(1) + 1e-9)).sum()


def _sample_all(flow_map, loc):
    k, b, n, _ = loc.shape
    flow = event_flow(flow_map, loc.permute(1, 0, 2, 3).reshape(b, k * n, 2))
    return flow.reshape(b, k, n, 2).permute(1, 0, 2, 3)


def _gate(loc, gm):
    return torch.where(gm > 0, loc, loc.detach())


def _step(flow_map, loc, ts, mask, tref, res):
    prop = loc + (tref - ts) * _sample_all(flow_map, loc)
    prop, mask = purge(prop, mask, res)
    return prop, mask.detach()


def warp_table(flow_maps, loc, ts, pol_mask, grad_mask, res):
    """``[P+1, P, B, N, 2]`` locations and masks of every window warped to
    every tref, the triangular table."""
    p = flow_maps.shape[0]
    fw_tab = []
    cl, ct, cm = loc[0:1], ts[0:1], pol_mask[0:1]
    for tau in range(p):
        if tau > 0:
            cl = torch.cat([cl, loc[tau:tau + 1]])
            ct = torch.cat([ct, ts[tau:tau + 1]])
            cm = torch.cat([cm, pol_mask[tau:tau + 1]])
        prop, cm = _step(flow_maps[tau], cl, ct, cm, tau + 1.0, res)
        fw_tab.append((_gate(prop, grad_mask[: tau + 1]), cm))
        cl = prop
        ct = torch.full_like(ct, tau + 1.0)
    bw_tab = [None] * p
    cl, ct, cm = loc[p - 1:], ts[p - 1:], pol_mask[p - 1:]
    for tau in range(p - 1, -1, -1):
        if tau < p - 1:
            cl = torch.cat([loc[tau:tau + 1], cl])
            ct = torch.cat([ts[tau:tau + 1], ct])
            cm = torch.cat([pol_mask[tau:tau + 1], cm])
        prop, cm = _step(flow_maps[tau], cl, ct, cm, float(tau), res)
        bw_tab[tau] = (_gate(prop, grad_mask[tau:]), cm)
        cl = prop
        ct = torch.full_like(ct, float(tau))
    tl, tm = [bw_tab[0][0]], [bw_tab[0][1]]
    for tref in range(1, p):
        tl.append(torch.cat([fw_tab[tref - 1][0][:tref], bw_tab[tref][0]]))
        tm.append(torch.cat([fw_tab[tref - 1][1][:tref], bw_tab[tref][1]]))
    tl.append(fw_tab[p - 1][0])
    tm.append(fw_tab[p - 1][1])
    return torch.stack(tl), torch.stack(tm)


def _window_inputs(event_list):
    p = event_list.shape[0]
    pass_ids = torch.arange(p, dtype=event_list.dtype,
                            device=event_list.device).reshape(p, 1, 1, 1)
    return event_list[..., 0:1] + pass_ids, event_list[..., 1:3]


def iterative_loss(flows, event_list, pol_mask, grad_mask, cfg):
    """``flows [P, S, B, H, W, 2]`` (scaled), events ``[P, B, N, 4]`` ->
    the Iterative loss; ``cfg`` holds ``res``, ``passes_loss``,
    ``scales_loss``, ``iterative_mode``."""
    p, s_scales = flows.shape[0], flows.shape[1]
    res = cfg["res"]
    ts, loc = _window_inputs(event_list)
    div = {"one": 1, "two": 2, "four": 4}[cfg["iterative_mode"]]
    passes_list = [cfg["passes_loss"] // (2 ** s)
                   for s in range(cfg["scales_loss"])]

    def scale_loss(flow_maps):
        tbl_loc, tbl_mask = warp_table(flow_maps, loc, ts, pol_mask,
                                       grad_mask, res)
        loss = 0.0
        for s, scale in enumerate(passes_list):
            delta = scale // div
            upd = 0.0
            for w in range(2 ** s):
                lo_p, hi_p = w * scale, (w + 1) * scale
                lo_t, hi_t = lo_p, hi_p + 1
                if cfg["iterative_mode"] == "four":
                    lo_t, hi_t = lo_p + delta, lo_p + 3 * delta + 1
                shared = torch.prod(tbl_mask[lo_t:hi_t], dim=0)
                for tref in range(lo_t, hi_t):
                    lo_e, hi_e = max(lo_p, tref - delta), min(hi_p,
                                                               tref + delta)
                    k = hi_e - lo_e
                    wl = tbl_loc[tref, lo_e:hi_e]
                    b, n = wl.shape[1], wl.shape[2]

                    def flat(x):
                        return x.permute(1, 0, 2, 3).reshape(b, k * n,
                                                             x.shape[-1])

                    norm_ts = 1.0 - torch.abs(tref - flat(ts[lo_e:hi_e])) \
                        / delta
                    iwe, iwe_ts = iwe_with_ts(flat(wl), flat(
                        shared[lo_e:hi_e]), norm_ts, res)
                    upd = upd + focus_loss(iwe, iwe_ts / (iwe + 1e-9))
            loss = loss + upd / (2 ** s) / (2 * delta + 1)
        return loss

    loss = sum(scale_loss(flows[:, i]) for i in range(s_scales))
    return loss / cfg["scales_loss"] / s_scales


def linear_loss(flows, event_list, pol_mask, grad_mask, cfg):
    """The Linear loss, same arguments as :func:`iterative_loss`."""
    p, s_scales = flows.shape[0], flows.shape[1]
    res = cfg["res"]
    ts, loc = _window_inputs(event_list)
    b, n = loc.shape[1], loc.shape[2]
    passes_list = [cfg["passes_loss"] // (2 ** s)
                   for s in range(cfg["scales_loss"])]
    loss = 0.0
    for i in range(s_scales):
        fm = flows[:, i]
        ev_flow = event_flow(fm.reshape(p * b, *fm.shape[2:]),
                             loc.reshape(p * b, -1, 2)).reshape(loc.shape)
        for s, scale in enumerate(passes_list):
            upd = 0.0
            for w in range(2 ** s):
                lo_p, hi_p = w * scale, (w + 1) * scale
                k = hi_p - lo_p

                def flat(x):
                    return x[lo_p:hi_p].permute(1, 0, 2, 3).reshape(
                        b, k * n, x.shape[-1])

                w_ts, w_loc = flat(ts), flat(loc)
                w_flow, w_mask = flat(ev_flow), flat(pol_mask)
                fw = w_loc + (float(hi_p) - w_ts) * w_flow
                bw = w_loc + (float(lo_p) - w_ts) * w_flow
                fw, w_mask = purge(fw, w_mask, res)
                bw, w_mask = purge(bw, w_mask, res)
                gm = flat(grad_mask) > 0
                fw = torch.where(gm, fw, fw.detach())
                bw = torch.where(gm, bw, bw.detach())
                fw_ts = 1.0 - torch.abs(hi_p - w_ts) / scale
                bw_ts = 1.0 - torch.abs(lo_p - w_ts) / scale
                for warped, norm_ts in ((fw, fw_ts), (bw, bw_ts)):
                    iwe, iwe_ts = iwe_with_ts(warped, w_mask, norm_ts, res)
                    upd = upd + focus_loss(iwe, iwe_ts / (iwe + 1e-9))
            loss = loss + upd / (2 ** s) / 2
    return loss / cfg["scales_loss"] / s_scales


LOSSES = {"Iterative": iterative_loss, "Linear": linear_loss}


def loss_for(loss_cfg):
    """The loss ``loss_cfg`` names; raises where it states an option this
    copy does not implement."""
    if loss_cfg["warping"] not in LOSSES:
        raise NotImplementedError(
            f"the reference has no {loss_cfg['warping']!r} loss")
    if loss_cfg.get("round_ts"):
        raise NotImplementedError("the reference implements round_ts: "
                                  "false only")
    return LOSSES[loss_cfg["warping"]]

"""The Iterative validation (FWL, RSAT, AEE, the accumulated backward flow)
and the DSEC u16 lattice, plain.

Frozen copy of ``taming_event_flow_tpu_torch/metrics/validation.py``
(``IterativeValidation.update`` without the backward-IWE and forward-
propagation tracks, which the benchmark's protocols leave off;
``window_flow("backward")``, ``window_events``, ``compute_rsat_fwl``,
``compute_aee``) and ``utils/visualization.py: flow_to_u16`` at commit
96ab861. Departures: the state holds only the real events of each pass
(the port's slots also hold padding rows, whose zero masks add nothing),
as lists instead of slot tensors; the splats are :mod:`.warp`'s.
"""

from __future__ import annotations

import torch

from .warp import event_flow, inside_mask, purge, splat, splat_rounded


def _grid(res, device):
    h, w = res
    flat = torch.arange(h * w, device=device)
    return torch.stack([(flat // w).float(), (flat % w).float()], -1)[None]


class Window:
    """One GT window's validation state, batch 1."""

    def __init__(self, res, device):
        h, w = res
        self.res = res
        self.ts, self.loc, self.pol = [], [], []
        self.fw_loc, self.fw_ts, self.fw_mask = [], [], []
        self.emask = []
        self.warp_idx = _grid(res, device).reshape(1, h, w, 2)
        self.accum = torch.zeros(1, h, w, 2, device=device)
        self.out_mask = torch.zeros(1, h, w, 1, device=device)

    def update(self, flow, events, pol, emask):
        """Ingest one pass: ``flow [1, H, W, 2]`` (scaled), ``events [1, n,
        4]``, ``pol [1, n, 2]``, ``emask [1, H, W, 1]``."""
        res = self.res
        h, w = res
        pf = float(len(self.ts))
        ts = events[..., 0:1] + pf
        loc = events[..., 1:3]
        self.ts.append(ts)
        self.loc.append(loc)
        self.pol.append(pol)
        self.emask.append(emask)
        self.fw_loc.append(loc)
        self.fw_ts.append(ts)
        self.fw_mask.append(pol)
        grid_pts = self.warp_idx.reshape(1, h * w, 2)
        sizes = [t.shape[1] for t in self.fw_loc]
        both = event_flow(flow, torch.cat(self.fw_loc + [grid_pts], dim=1))
        flows = torch.split(both, sizes + [h * w], dim=1)
        for i in range(len(sizes)):
            prop = self.fw_loc[i] + (pf + 1.0 - self.fw_ts[i]) * flows[i]
            self.fw_loc[i], self.fw_mask[i] = purge(prop, self.fw_mask[i],
                                                    res)
            self.fw_ts[i] = torch.full_like(self.fw_ts[i], pf + 1.0)
        valid = inside_mask(self.warp_idx, res)
        warped = self.warp_idx + flows[-1].reshape(1, h, w, 2) * valid
        grid = _grid(res, flow.device).reshape(1, h, w, 2)
        self.accum = torch.stack([warped[..., 1] - grid[..., 1],
                                  warped[..., 0] - grid[..., 0]], -1)
        self.warp_idx = warped
        self.out_mask = self.out_mask + valid

    def backward_flow(self):
        """The window's accumulated backward flow per pass (the port's
        ``window_flow(mode="backward", mask=False)``)."""
        maps = (self.accum / (self.out_mask + 1e-9))[None]
        nonzero = ((maps[..., 0:1] != 0) | (maps[..., 1:2] != 0)).float()
        return maps.sum(0) / (nonzero.sum(0) + 1e-9)

    def _cat(self, parts):
        return torch.cat(parts, dim=1)

    def event_image(self):
        """The window's events at their own pixels (``window_events``)."""
        return splat(self._cat(self.loc), self._cat(self.pol), self.res)

    def rsat_fwl(self):
        n_passes = max(float(len(self.ts)), 1.0)
        ts = self._cat(self.ts)
        fw = _ts_sums(self._cat(self.fw_loc), self._cat(self.fw_mask), ts,
                      self.res)
        zz = _ts_sums(self._cat(self.loc), self._cat(self.pol), ts,
                      self.res)
        rsat = _rsat_term(*fw, n_passes) / _rsat_term(*zz, n_passes)
        fwl = _var(fw[0] + fw[1]) / _var(zz[0] + zz[1])
        return rsat[0], fwl


def _ts_sums(events, pol, ts, res):
    vals = torch.cat([pol[..., 0:1], pol[..., 1:2], pol[..., 0:1] * ts,
                      pol[..., 1:2] * ts], -1)
    buf = splat_rounded(events, vals, res)
    return buf[..., 0:1], buf[..., 1:2], buf[..., 2:3], buf[..., 3:4]


def _var(x):
    return torch.var(x, correction=0)


def _rsat_term(pos, neg, pos_ts, neg_ts, num_passes):
    pos_ts = pos_ts / (pos + 1e-9) / num_passes
    neg_ts = neg_ts / (neg + 1e-9) / num_passes
    b = pos_ts.shape[0]
    s = (pos_ts.reshape(b, -1) ** 2).sum(1) + (neg_ts.reshape(b, -1) ** 2
                                                ).sum(1)
    return s / ((pos + neg) > 0).reshape(b, -1).sum(1)


def compute_aee(pred, gt, event_mask=None, res_aee=None,
                vertical_crop_aee=None):
    error = torch.sqrt(((pred - gt) ** 2).sum(-1))
    valid = ~((gt[..., 0] == 0.0) & (gt[..., 1] == 0.0))
    if event_mask is not None:
        m = event_mask.sum(-1) > 0
        h, w = pred.shape[1], pred.shape[2]
        if res_aee is not None:
            yoff, xoff = (h - res_aee[0]) // 2, (w - res_aee[1]) // 2
            m = m[:, yoff: h - yoff, xoff: w - xoff]
            error = error[:, yoff: h - yoff, xoff: w - xoff]
            valid = valid[:, yoff: h - yoff, xoff: w - xoff]
        if vertical_crop_aee is not None:
            m = m[:, :vertical_crop_aee, :]
            error = error[:, :vertical_crop_aee, :]
            valid = valid[:, :vertical_crop_aee, :]
        valid = valid & m
    vf = valid.float()
    return (error * vf).sum() / (vf.sum() + 1e-9)


def flow_to_u16(flow):
    return torch.clamp(flow * 128.0 + 2.0 ** 15, 0.0, 65535.0).to(
        torch.int32)

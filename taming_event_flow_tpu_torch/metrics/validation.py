"""Validation metrics: FWL / RSAT / AEE and the incremental warp state.

The PyTorch counterpart of ``taming_event_flow_tpu/metrics/validation.py``
(the Iterative and the Linear schemes). The state keeps the JAX package's
slot-per-pass layout (``[P, ...]`` leading axis, zero-masked empty slots),
but PyTorch runs eagerly, so the port updates it in place instead of
returning a fresh copy: the slot buffers are the largest arrays of the eval
path (104 MB at DSEC 480x640, P=10, N=65,536, computed from the shapes) and
copying them every pass would double the memory traffic. ``pass_idx`` is a
host integer: the pipeline knows the pass count anyway, and a device scalar
would cost a synchronise per pass.

All state tensors are made and changed under ``torch.inference_mode()``.

Event-sharded evaluation (``parallel/eval.py``) holds N / E slots per rank:
the window reducers take an ``event_axis`` (the event group) and all-reduce
their partial images over it before any variance or ratio; ``update``
needs no collective (the warp is per event) and ``window_flow`` reads the
replicated pixel accumulators.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ..ops.warp import (
    event_propagation,
    get_event_flow,
    inside_mask,
    iwe_from_events,
    purge_unfeasible,
    splat_values,
)
from ..parallel.collectives import all_reduce_sum
from ..utils.device import resolve_device


class ValConfig(NamedTuple):
    res: Tuple[int, int]
    passes: int
    round_ts: bool = False
    # forward-propagated flow maps feed only window_flow("forward")
    track_fw_prop: bool = True
    # the backward re-warp of each window feeds only window_iwe("backward")
    track_bw: bool = True


def _grid(res, device, dtype=torch.float32):
    """``[1, H*W, 2]`` (y, x) pixel grid."""
    h, w = res
    flat = torch.arange(h * w, device=device)
    return torch.stack([(flat // w).to(dtype), (flat % w).to(dtype)],
                       dim=-1)[None]


def forward_prop_flow_once(flow_map, res, dt: float = 1.0):
    """Push a flow map ``dt`` steps forward along itself: a bilinear splat
    of ``(weight, w * fy, w * fx)`` (3 channels) from the warped pixel grid,
    then a weight-normalised read (reference ``loss/flow_val.py:43-74``).

    :param flow_map: ``[B, H, W, 2]`` (x, y).
    :param dt: the steps, a number or a ``[B, 1, 1]`` tensor of one per map.
    :return: ``[B, H, W, 2]`` forward-propagated flow map.
    """
    b = flow_map.shape[0]
    hw = res[0] * res[1]
    grid = _grid(res, flow_map.device, flow_map.dtype).expand(b, hw, 2)
    fm = flow_map.reshape(b, hw, 2)
    flow_at = torch.stack([fm[..., 1], fm[..., 0]], dim=-1)  # (y, x)
    warped = grid + dt * flow_at
    ones = torch.ones(b, hw, 1, dtype=flow_map.dtype, device=flow_map.device)
    warped, mask = purge_unfeasible(warped, ones, res)
    vals = torch.cat(
        [mask, mask * flow_at[..., 0:1], mask * flow_at[..., 1:2]], dim=-1)
    buf = splat_values(warped, vals, res)
    wsum = buf[..., 0:1]
    wy = buf[..., 1:2] / (wsum + 1e-9)
    wx = buf[..., 2:3] / (wsum + 1e-9)
    return torch.cat([wx, wy], dim=-1)


@dataclasses.dataclass
class ValState:
    """Slot-per-pass validation state (shapes static in P, B, N, H, W)."""

    pass_idx: int
    event_ts: torch.Tensor  # [P, B, N, 1] global-timeline ts
    event_loc: torch.Tensor  # [P, B, N, 2] original (y, x)
    pol_mask: torch.Tensor  # [P, B, N, 2]
    flow_maps: torch.Tensor  # [P, B, H, W, 2] finest-scale flow per pass
    event_mask_maps: torch.Tensor  # [P, B, H, W, 1]
    fw_loc: torch.Tensor  # [P, B, N, 2] incrementally fw-warped events
    fw_ts: torch.Tensor  # [P, B, N, 1]
    fw_mask: torch.Tensor  # [P, B, N, 2]
    bw_loc: torch.Tensor  # [P, B, N, 2] events bw-warped to t = 0
    bw_mask: torch.Tensor  # [P, B, N, 2]
    fw_prop_flow: torch.Tensor  # [P, B, H, W, 2]
    accum_flow: torch.Tensor  # [B, H, W, 2] accumulated bw flow (x, y)
    warp_indices: torch.Tensor  # [B, H, W, 2] iterated warp grid (y, x)
    out_mask: torch.Tensor  # [B, H, W, 1] valid-pass counter

    def tensors(self):
        return [getattr(self, f.name) for f in dataclasses.fields(self)
                if f.name != "pass_idx"]


def _flat(t):
    """``[P, B, N, C]`` slots -> ``[B, P*N, C]``."""
    p, b, n, c = t.shape
    return t.transpose(0, 1).reshape(b, p * n, c)


class IterativeValidation:
    """Iterative validation scheme (reference ``loss/flow_val.py:419-694``).

    Usage::

        val = IterativeValidation(cfg, batch, n_events, device)
        state = val.init()
        state = val.update(state, flow, events, pol_mask, event_mask)
        rsat, fwl = val.rsat_fwl(state)
    """

    def __init__(self, cfg: ValConfig, batch: int, n_events: int,
                 device="cuda"):
        self.cfg = cfg
        self.batch = batch
        self.n_events = n_events
        self.device = resolve_device(device)

    @torch.inference_mode()
    def init(self) -> ValState:
        p, b, n = self.cfg.passes, self.batch, self.n_events
        h, w = self.cfg.res

        def z(*shape):
            return torch.zeros(*shape, device=self.device)

        return ValState(
            pass_idx=0,
            event_ts=z(p, b, n, 1), event_loc=z(p, b, n, 2),
            pol_mask=z(p, b, n, 2), flow_maps=z(p, b, h, w, 2),
            event_mask_maps=z(p, b, h, w, 1), fw_loc=z(p, b, n, 2),
            fw_ts=z(p, b, n, 1), fw_mask=z(p, b, n, 2),
            bw_loc=z(p, b, n, 2), bw_mask=z(p, b, n, 2),
            fw_prop_flow=z(p, b, h, w, 2), accum_flow=z(b, h, w, 2),
            warp_indices=_grid(self.cfg.res, self.device).reshape(
                1, h, w, 2).repeat(b, 1, 1, 1),
            out_mask=z(b, h, w, 1),
        )

    @torch.inference_mode()
    def reset(self, state: ValState) -> ValState:
        """Window-boundary reset of the existing buffers, in place
        (equivalent to :meth:`init`)."""
        h, w = self.cfg.res
        for t in state.tensors():
            t.zero_()
        state.warp_indices.copy_(
            _grid(self.cfg.res, self.device).reshape(1, h, w, 2)
            .expand_as(state.warp_indices))
        state.pass_idx = 0
        return state

    @torch.inference_mode()
    def update(self, state: ValState, flow, event_list, pol_mask,
               event_mask, n_active: Optional[int] = None) -> ValState:
        """Ingest one pass (reference ``loss/flow_val.py:477-607``), in place.

        :param flow: ``[B, H, W, 2]`` finest-scale flow (flow_scaling'd).
        :param event_list: ``[B, N, 4]`` events ``(ts, y, x, p)``, ts in [0,1].
        :param pol_mask: ``[B, N, 2]``.
        :param event_mask: ``[B, H, W, 1]``.
        :param n_active: optional pass count ``pass_idx + 1``: the forward
            warp then runs on the occupied slots only; ``None`` warps all P
            slots and masks the empty ones. Both give the same state.
        """
        cfg = self.cfg
        res = cfg.res
        h, w = res
        p_cur = state.pass_idx
        pf = float(p_cur)

        ts = event_list[..., 0:1] + pf
        if cfg.round_ts:
            # unmasked min: the loader's first real event has ts 0, like
            # the padding rows (see the JAX package)
            ts = (ts.min() + 0.5).expand(ts.shape)
        loc = event_list[..., 1:3]

        for buf, val in ((state.event_ts, ts), (state.event_loc, loc),
                         (state.pol_mask, pol_mask),
                         (state.flow_maps, flow),
                         (state.event_mask_maps, event_mask),
                         (state.fw_loc, loc), (state.fw_ts, ts),
                         (state.fw_mask, pol_mask)):
            buf[p_cur] = val

        # incremental forward warp of every stored window to p+1, fused with
        # the accumulated-grid lookup: both sample THIS pass's flow map, so
        # one gather covers [k*N events | H*W grid points]
        pp, bb, nn_, _ = state.fw_loc.shape
        k = pp if n_active is None else n_active
        fw_flat = _flat(state.fw_loc[:k])
        grid_pts = state.warp_indices.reshape(bb, h * w, 2)
        both = get_event_flow(flow, torch.cat([fw_flat, grid_pts], dim=1))
        fw_flow = both[:, : k * nn_].reshape(bb, k, nn_, 2).transpose(0, 1)
        grid_flow = both[:, k * nn_:]
        prop = state.fw_loc[:k] + (pf + 1.0 - state.fw_ts[:k]) * fw_flow
        prop, purged = purge_unfeasible(prop, state.fw_mask[:k], res)
        if n_active is None:
            active = (torch.arange(pp, device=prop.device) <= p_cur).view(
                -1, 1, 1, 1)
            state.fw_loc = torch.where(active, prop, state.fw_loc)
            state.fw_mask = torch.where(active, purged, state.fw_mask)
            state.fw_ts = torch.where(active, pf + 1.0, state.fw_ts)
        else:
            state.fw_loc[:k] = prop
            state.fw_mask[:k] = purged
            state.fw_ts[:k] = pf + 1.0

        if cfg.track_bw:
            self._update_bw(state, loc, pol_mask, ts, p_cur, n_active)

        if cfg.track_fw_prop:
            # every older slot advances one step along itself
            state.fw_prop_flow[p_cur] = flow
            if p_cur > 0:
                old = state.fw_prop_flow[:p_cur]
                state.fw_prop_flow[:p_cur] = forward_prop_flow_once(
                    old.reshape(-1, h, w, 2), res).reshape(old.shape)

        # accumulated backward flow via iterated grid warping
        indices = state.warp_indices
        mask_valid = inside_mask(indices, res)
        curr = grid_flow.reshape(bb, h, w, 2)  # (y, x) per px
        warped_idx = indices + curr * mask_valid
        grid_map = _grid(res, indices.device).reshape(1, h, w, 2)
        state.accum_flow = torch.stack(
            [warped_idx[..., 1] - grid_map[..., 1],
             warped_idx[..., 0] - grid_map[..., 0]], dim=-1)
        state.warp_indices = warped_idx
        state.out_mask = state.out_mask + mask_valid
        state.pass_idx = p_cur + 1
        return state

    def _update_bw(self, state, loc, pol_mask, ts, p_cur, n_active=None):
        """Backward warp of THIS window to t=0 through every stored map
        (reference ``loss/flow_val.py:519-556``); slots after ``p_cur`` are
        inactive and leave the events where they are."""
        k = self.cfg.passes if n_active is None else n_active
        b_loc, b_mask, b_ts = loc, pol_mask, ts
        for tau in reversed(range(k)):
            if tau > p_cur:
                continue
            bflow = get_event_flow(state.flow_maps[tau], b_loc)
            nl = b_loc + (float(tau) - b_ts) * bflow
            b_loc, b_mask = purge_unfeasible(nl, b_mask, self.cfg.res)
            b_ts = float(tau)
        state.bw_loc[p_cur] = b_loc
        state.bw_mask[p_cur] = b_mask

    # ---------------- window accessors (reference flow_val.py:630-678) ----

    @torch.inference_mode()
    def window_events(self, state: ValState, round_idx: bool = False,
                      event_axis=None):
        return _merged(iwe_from_events(
            _flat(state.event_loc), _flat(state.pol_mask), self.cfg.res,
            round_idx=round_idx), event_axis)

    @torch.inference_mode()
    def window_iwe(self, state: ValState, mode: str = "forward",
                   round_idx: bool = False, event_axis=None):
        if mode == "forward":
            loc, mask = state.fw_loc, state.fw_mask
        elif mode == "backward":
            if not self.cfg.track_bw:
                raise ValueError(
                    "window_iwe('backward') needs ValConfig.track_bw=True")
            loc, mask = state.bw_loc, state.bw_mask
        else:
            raise ValueError(f"Invalid IWE mode: {mode}")
        return _merged(iwe_from_events(_flat(loc), _flat(mask), self.cfg.res,
                                       round_idx=round_idx), event_axis)

    @torch.inference_mode()
    def window_flow(self, state: ValState, mode: Optional[str] = None,
                    mask: bool = False):
        """Per-pixel average flow over the window
        (reference ``loss/flow_val.py:145-169, 638-653``)."""
        if mode == "forward":
            if not self.cfg.track_fw_prop:
                raise ValueError(
                    "window_flow('forward') needs ValConfig.track_fw_prop"
                    "=True")
            maps = state.fw_prop_flow
        elif mode == "backward":
            maps = (state.accum_flow / (state.out_mask + 1e-9))[None]
        else:
            maps = state.flow_maps
        nonzero = ((maps[..., 0:1] != 0) | (maps[..., 1:2] != 0)).to(
            maps.dtype)
        out = maps.sum(0) / (nonzero.sum(0) + 1e-9)
        if mask:
            out = out * (state.event_mask_maps.sum(0) > 0).to(out.dtype)
        return out

    # ---------------- metrics ------------------------------------------

    def _num_passes(self, state):
        return max(float(state.pass_idx), 1.0)

    def _window_args(self, state):
        return (_flat(state.fw_loc), _flat(state.event_loc),
                _flat(state.fw_mask), _flat(state.pol_mask))

    @torch.inference_mode()
    def rsat(self, state: ValState, event_axis=None):
        return compute_rsat(*self._window_args(state), _flat(state.event_ts),
                            self._num_passes(state), self.cfg.res,
                            event_axis=event_axis)

    @torch.inference_mode()
    def fwl(self, state: ValState, event_axis=None):
        return compute_fwl(*self._window_args(state), self.cfg.res,
                           event_axis=event_axis)

    @torch.inference_mode()
    def rsat_fwl(self, state: ValState, event_axis=None):
        """Both window metrics from two shared splats
        (:func:`compute_rsat_fwl`)."""
        return compute_rsat_fwl(*self._window_args(state),
                                _flat(state.event_ts),
                                self._num_passes(state), self.cfg.res,
                                event_axis=event_axis)


class LinearValidation(IterativeValidation):
    """Linear validation scheme (reference ``loss/flow_val.py:317-416``).

    Each event samples its arrival pass's flow once (one gather per pass);
    the warp to ``t = pass_idx`` happens in the window accessors and
    metrics (RSAT and FWL through :meth:`_window_args`). It keeps the slot state of :class:`IterativeValidation`, with
    ``fw_loc`` holding each event's *flow* in place of a warped location;
    the Iterative-only slots (``fw_ts``, ``fw_mask``, ``bw_*``,
    ``fw_prop_flow``, the accumulated grid warp) stay untouched.
    """

    @torch.inference_mode()
    def update(self, state: ValState, flow, event_list, pol_mask,
               event_mask, n_active: Optional[int] = None) -> ValState:
        """Ingest one pass, in place. ``n_active`` is taken for the
        interface's sake: the update touches only the new slot."""
        p_cur = state.pass_idx
        ts = event_list[..., 0:1] + float(p_cur)
        if self.cfg.round_ts:
            # unmasked min, as in IterativeValidation.update
            ts = (ts.min() + 0.5).expand(ts.shape)
        loc = event_list[..., 1:3]
        for buf, val in ((state.event_ts, ts), (state.event_loc, loc),
                         (state.pol_mask, pol_mask),
                         (state.flow_maps, flow),
                         (state.event_mask_maps, event_mask),
                         (state.fw_loc, get_event_flow(flow, loc))):
            buf[p_cur] = val
        state.pass_idx = p_cur + 1
        return state

    def _fw_events(self, state):
        """Every stored event warped to ``t = pass_idx`` with its own flow:
        ``(warped [B, P*N, 2], loc, pol_mask)``."""
        loc = _flat(state.event_loc)
        warped = event_propagation(_flat(state.event_ts), loc,
                                   _flat(state.fw_loc),
                                   float(state.pass_idx))
        return warped, loc, _flat(state.pol_mask)

    @torch.inference_mode()
    def window_iwe(self, state: ValState, mode: str = "forward",
                   round_idx: bool = False, event_axis=None):
        """The forward IWE, whatever ``mode`` says: the reference's Linear
        ``window_iwe`` ignores it (``flow_val.py:393-400``), so the
        ``iwe_bw_*`` panels show the forward IWE too."""
        fw, _, mask = self._fw_events(state)
        return _merged(iwe_from_events(fw, mask, self.cfg.res,
                                       round_idx=round_idx), event_axis)

    @torch.inference_mode()
    def window_flow(self, state: ValState, mode: Optional[str] = None,
                    mask: bool = False):
        """Every older map pushed forward to the latest pass with one
        long-range warp of ``dt = latest - t`` (one splat for them all),
        then the per-pixel non-zero mean (reference ``flow_val.py:
        369-391``). ``mode`` is ignored, as in the reference."""
        maps = state.flow_maps
        latest = state.pass_idx - 1
        if latest > 0:
            p, b, h, w, _ = maps.shape
            old = maps[:latest]
            dt = torch.arange(latest, 0, -1, dtype=maps.dtype,
                              device=maps.device).repeat_interleave(b)
            warped = forward_prop_flow_once(
                old.reshape(-1, h, w, 2), self.cfg.res,
                dt.view(-1, 1, 1)).reshape(old.shape)
            maps = torch.cat([warped, maps[latest:]])
        nonzero = ((maps[..., 0:1] != 0) | (maps[..., 1:2] != 0)).to(
            maps.dtype)
        out = maps.sum(0) / (nonzero.sum(0) + 1e-9)
        if mask:
            out = out * (state.event_mask_maps.sum(0) > 0).to(out.dtype)
        return out

    def _window_args(self, state):
        # the metrics' event sets: the lazily warped events and the
        # originals, with the flattened polarity mask for both (as the JAX
        # class)
        fw, loc, pol = self._fw_events(state)
        return fw, loc, pol, pol


def grow_val_state(state: ValState, n_new: int) -> ValState:
    """Widen the event axis of the slot state (zero padding) so a larger
    event bucket can be ingested without losing accumulated passes."""
    with torch.inference_mode():
        def widen(t):
            pad = n_new - t.shape[2]
            return torch.nn.functional.pad(t, (0, 0, 0, pad)) if pad > 0 \
                else t

        return dataclasses.replace(state, **{
            name: widen(getattr(state, name))
            for name in ("event_ts", "event_loc", "pol_mask", "fw_loc",
                         "fw_ts", "fw_mask", "bw_loc", "bw_mask")})


def _merged(image, event_axis):
    """A partial image of this rank's events merged over the event group
    (the image itself without one)."""
    return image if event_axis is None else all_reduce_sum(image, event_axis)


def _ts_image_sums(events, pol_mask, ts, res, event_axis=None):
    """Per-polarity count + ts-sum images for RSAT (one 4-channel
    round_idx splat, merged over ``event_axis``)."""
    vals = torch.cat(
        [pol_mask[..., 0:1], pol_mask[..., 1:2],
         pol_mask[..., 0:1] * ts, pol_mask[..., 1:2] * ts], dim=-1)
    buf = _merged(splat_values(events, vals, res, round_idx=True),
                  event_axis)
    return buf[..., 0:1], buf[..., 1:2], buf[..., 2:3], buf[..., 3:4]


def _var(x):
    # jnp.var is the population variance; torch's default is unbiased
    return torch.var(x, correction=0)


def compute_fwl(fw_events, zero_events, fw_pol, zero_pol, res,
                event_axis=None):
    """Flow Warp Loss: var(IWE) / var(zero-warp IWE)
    (reference ``loss/flow_val.py:189-212``). With ``event_axis`` (the
    event group of a sharded slot state) the partial IWEs are merged over
    it before the variances."""
    fw_iwe = splat_values(fw_events, fw_pol.sum(-1, keepdim=True), res,
                          round_idx=True)
    z_iwe = splat_values(zero_events, zero_pol.sum(-1, keepdim=True), res,
                         round_idx=True)
    return (_var(_merged(fw_iwe, event_axis))
            / _var(_merged(z_iwe, event_axis)))


def _rsat_term(pos, neg, pos_ts, neg_ts, num_passes):
    pos_ts = pos_ts / (pos + 1e-9) / num_passes
    neg_ts = neg_ts / (neg + 1e-9) / num_passes
    b = pos_ts.shape[0]
    s = (pos_ts.reshape(b, -1) ** 2).sum(1) + (neg_ts.reshape(b, -1) ** 2).sum(1)
    nonzero = ((pos + neg) > 0).reshape(b, -1)
    return s / nonzero.sum(1)


def compute_rsat(fw_events, zero_events, fw_pol, zero_pol, ts, num_passes,
                 res, event_axis=None):
    """Ratio of Squared Averaged Timestamps, ``[B]``
    (reference ``loss/flow_val.py:214-274``); ``event_axis`` as in
    :func:`compute_fwl`: the count and ts images are merged before any
    ratio."""
    fw = _ts_image_sums(fw_events, fw_pol, ts, res, event_axis)
    zz = _ts_image_sums(zero_events, zero_pol, ts, res, event_axis)
    return _rsat_term(*fw, num_passes) / _rsat_term(*zz, num_passes)


def compute_rsat_fwl(fw_events, zero_events, fw_pol, zero_pol, ts,
                     num_passes, res, event_axis=None):
    """RSAT and FWL from TWO shared 4-channel splats: FWL's count image is
    the sum of RSAT's per-polarity count planes. The planes are sums of 0/1
    masks, exact in float32 whatever the order of accumulation (atomics on
    the card included), so FWL is bitwise equal to :func:`compute_fwl`'s.

    ``event_axis`` as in :func:`compute_fwl`.

    :return: ``(rsat [B], fwl scalar)``.
    """
    fw = _ts_image_sums(fw_events, fw_pol, ts, res, event_axis)
    zz = _ts_image_sums(zero_events, zero_pol, ts, res, event_axis)
    rsat = _rsat_term(*fw, num_passes) / _rsat_term(*zz, num_passes)
    fwl = _var(fw[0] + fw[1]) / _var(zz[0] + zz[1])
    return rsat, fwl


def compute_aee(pred, gt, event_mask=None, res_aee=None,
                vertical_crop_aee=None):
    """Average endpoint error with the reference's masking protocol
    (reference ``loss/flow_val.py:276-314``); the crops apply only with an
    ``event_mask``, as in the reference.

    :param pred, gt: ``[B, H, W, 2]`` displacement (x, y).
    """
    error = torch.sqrt(((pred - gt) ** 2).sum(-1))
    valid = ~((gt[..., 0] == 0.0) & (gt[..., 1] == 0.0))
    if event_mask is not None:
        m = event_mask.sum(-1) > 0
        h, w = pred.shape[1], pred.shape[2]
        if res_aee is not None:
            yoff = (h - res_aee[0]) // 2
            xoff = (w - res_aee[1]) // 2
            m = m[:, yoff: h - yoff, xoff: w - xoff]
            error = error[:, yoff: h - yoff, xoff: w - xoff]
            valid = valid[:, yoff: h - yoff, xoff: w - xoff]
        if vertical_crop_aee is not None:
            m = m[:, :vertical_crop_aee, :]
            error = error[:, :vertical_crop_aee, :]
            valid = valid[:, :vertical_crop_aee, :]
        valid = valid & m
    vf = valid.to(error.dtype)
    return (error * vf).sum() / (vf.sum() + 1e-9)


METRIC_REGISTRY = {
    "Iterative": IterativeValidation,
    "Linear": LinearValidation,
}

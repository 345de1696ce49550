"""The reference training step: the model, the loss, the backward, the
global-norm clip and Adam, plain.

Frozen copy of ``taming_event_flow_tpu_torch/training/step.py``
(``make_train_step``, ``run_passes``, ``clip_by_global_norm_``,
``build_optimizer``'s Adam with optax's defaults) and of the count input of
``ops/encodings.py: derive_count_input`` at commit 96ab861. Departures: Adam
is written out (``m``, ``v``, bias corrections, ``eps`` outside the square
root, as optax and ``torch.optim.Adam`` compute it); the count input is
built with ``index_put_`` from the benchmark's own event lists, not from
the program's wire.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from . import no_tf32
from .losses import loss_for
from .models import lookup

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def count_input(event_list, res):
    """``[..., N, 4]`` (ts, y, x, p) -> ``[..., H, W, 2]`` per-polarity
    counts at the integer coordinates (padding rows have p = 0)."""
    h, w = res
    lead = event_list.shape[:-2]
    ev = event_list.reshape(-1, event_list.shape[-2], 4)
    lanes = ev.shape[0]
    y = ev[..., 1].long().clamp(0, h - 1)
    x = ev[..., 2].long().clamp(0, w - 1)
    p = ev[..., 3]
    img = torch.zeros(lanes, h, w, 2, device=ev.device)
    lane = torch.arange(lanes, device=ev.device)[:, None].expand_as(y)
    img.index_put_((lane, y, x, (p < 0).long()), p.abs(), accumulate=True)
    return img.reshape(*lead, h, w, 2)


def clip_(grads: List[torch.Tensor], max_norm: float) -> None:
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    if norm >= max_norm:
        for g in grads:
            g.mul_(max_norm / norm)


def run_steps(weights: Dict[str, torch.Tensor], cfg: Dict,
              windows: List[Dict[str, torch.Tensor]],
              quant: Optional[Callable] = None, half_batch: bool = False):
    """Train a copy of ``weights`` for ``len(windows)`` steps. Each window
    holds ``event_list [P, B, N, 4]`` and ``grad_mask [P, B, N, 1]`` on the
    device. Returns ``(losses, first_flows, change, first_grad)``: the loss
    of every step, the model's flows of step 1 (``[P, S, B, H, W, 2]``,
    before ``flow_scaling``), every parameter's change over the steps, and
    the clipped gradient of step 1 as Adam holds it (``m / (1 - beta1)``).

    ``quant`` computes the model's convolutions in a lower precision (a
    control); ``half_batch`` takes the loss over the first half of the
    lanes and scales it by two (a fault), both to show the comparison
    fails them."""
    no_tf32()
    mcfg, lcfg, ocfg = cfg["model"], cfg["loss"], cfg["optimizer"]
    params = {k: v.detach().clone().requires_grad_() for k, v in
              weights.items()}
    start = {k: v.detach().clone() for k, v in weights.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v = {k: torch.zeros_like(v) for k, v in params.items()}
    ref_model = lookup(mcfg)
    loss_fn = loss_for(lcfg)
    res = tuple(windows[0]["res"])
    loss_cfg = {"res": res, "passes_loss": lcfg["passes_loss"],
                "scales_loss": lcfg["scales_loss"],
                "iterative_mode": lcfg.get("iterative_mode", "two")}
    b = windows[0]["event_list"].shape[1]
    carry = ref_model.init_state(mcfg, b, res[0], res[1],
                                 device=start[next(iter(start))].device)
    losses, first_grad, first_flows = [], None, None
    for t, win in enumerate(windows, start=1):
        ev, gm = win["event_list"], win["grad_mask"]
        xs = count_input(ev, res)
        pol = torch.stack([ev[..., 3] > 0, ev[..., 3] < 0], -1).float()
        flows = []
        for x in xs:
            f, carry = ref_model.forward(params, mcfg, x, carry, quant=quant)
            flows.append(f * lcfg["flow_scaling"])
        flows = torch.stack(flows)
        if t == 1:
            first_flows = flows.detach() / lcfg["flow_scaling"]
        if half_batch:
            h = b // 2
            loss = 2.0 * loss_fn(flows[:, :, :h], ev[:, :h], pol[:, :h],
                                 gm[:, :h], loss_cfg)
        else:
            loss = loss_fn(flows, ev, pol, gm, loss_cfg)
        grads = torch.autograd.grad(loss, list(params.values()))
        carry = tuple(c.detach() for c in carry)
        grads = [g.detach().clone() for g in grads]
        if lcfg.get("clip_grad") is not None:
            clip_(grads, lcfg["clip_grad"])
        lr = ocfg["lr"]
        with torch.no_grad():
            for (name, p), g in zip(params.items(), grads):
                m[name].mul_(BETA1).add_(g, alpha=1 - BETA1)
                v[name].mul_(BETA2).addcmul_(g, g, value=1 - BETA2)
                mh = m[name] / (1 - BETA1 ** t)
                vh = v[name] / (1 - BETA2 ** t)
                p.sub_(lr * mh / (vh.sqrt() + EPS))
        if t == 1:
            first_grad = {k: m[k] / (1 - BETA1) for k in m}
        losses.append(float(loss.detach()))
        del flows, loss, grads
    change = {k: params[k].detach() - start[k] for k in params}
    return losses, first_flows, change, first_grad

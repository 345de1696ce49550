"""Training and eval steps: the PyTorch counterpart of
``taming_event_flow_tpu/training/step.py``.

The JAX builders return jitted pure programs; here they return plain
closures that run eagerly. The model holds its own weights and the
optimizer its own moments, so no ``params`` or ``opt_state`` travels with
each call: the train step updates both in place and returns a
:class:`TrainState` of what does travel, the recurrent carry and the step
count.

Training (:func:`make_train_step`): P recurrent passes with grad enabled,
the contrast-max loss on the stacked flows, one backward through all passes
and the warp, a global-norm clip and the optimizer update. The carry handed
to the next window is detached: truncated BPTT at the window edge, as the
JAX step's pure carry is (reference ``models/model.py:50-60``).

Eval (:func:`make_eval_step`, :func:`make_eval_window_step`) runs under
``torch.inference_mode()``. ``inference_dtype`` (e.g. ``torch.bfloat16``)
is the JAX package's contract (``step.py:225-235, 349-358``): the model,
the carry and the input are cast to it for the forward pass, and the flow is
cast back to float32 before the validation update, which stays float32. The
builders cast a copy of the model once, so later changes to the caller's
model do not reach a built step.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..objectives import LOSS_REGISTRY, LossConfig
from ..ops.encodings import derive_count_input
from ..utils.device import resolve_device


class TrainState(NamedTuple):
    """What one train step hands the next: the model's recurrent carry
    (detached, ``[B, ...]`` NCHW maps) and the number of steps taken."""

    carry: Tuple[torch.Tensor, ...]
    step: int


def _on(params, dev: torch.device, what: str):
    for p in params:
        if p.device.type != dev.type:
            raise ValueError(f"{what} lies on {p.device}, not on {dev}")


def clip_by_global_norm_(params, max_norm: float) -> None:
    """optax ``clip_by_global_norm`` on the parameters' ``.grad``, in
    place: ``g <- g / norm * max_norm`` when the global norm reaches
    ``max_norm`` (no epsilon, unlike ``torch.nn.utils.clip_grad_norm_``,
    which adds 1e-6), computed on the device without a host sync."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def build_optimizer(opt_config: Dict, params, clip_grad: Optional[float] =
                    None, device="cuda") -> torch.optim.Optimizer:
    """The optimizer the JAX package builds with optax
    (``step.py:32-50``), for ``params`` that lie on ``device`` (the card
    unless the caller asks for the CPU).

    ``Adam``/``AdamW``/``SGD`` at ``opt_config["lr"]`` (default 1e-5) with
    optax's defaults: betas (0.9, 0.999), eps 1e-8, AdamW weight decay 1e-4
    (torch's default is 1e-2), SGD without momentum. ``clip_grad`` clips the
    global gradient norm before every step (:func:`clip_by_global_norm_`,
    a step pre-hook), as the JAX chain does.
    """
    dev = resolve_device(device)
    params = list(params)
    _on(params, dev, "a parameter")
    name = opt_config.get("name", "Adam").lower()
    lr = opt_config.get("lr", 1e-5)
    table = {
        "adam": lambda: torch.optim.Adam(params, lr=lr, eps=1e-8),
        "adamw": lambda: torch.optim.AdamW(params, lr=lr, eps=1e-8,
                                           weight_decay=1e-4),
        "sgd": lambda: torch.optim.SGD(params, lr=lr),
    }
    if name not in table:
        raise ValueError(f"Unknown optimizer: {name!r}")
    opt = table[name]()
    if clip_grad is not None:
        opt.register_step_pre_hook(
            lambda o, args, kwargs: clip_by_global_norm_(params, clip_grad))
    return opt


def init_train_state(model, batch: int, height: int, width: int,
                     device="cuda") -> TrainState:
    """A zero carry for ``batch`` lanes on ``device`` (the card unless the
    caller asks for the CPU), where the model must lie too."""
    dev = resolve_device(device)
    _on(model.parameters(), dev, "the model")
    return TrainState(model.init_state(batch, height, width, device=dev), 0)


def unpack_window(window: Dict[str, torch.Tensor],
                  res: Optional[tuple] = None) -> Dict[str, torch.Tensor]:
    """The window a train step consumes, cast to float32 where the loader's
    arrays may be narrower (``step.py:53-97``). A window without
    ``net_input`` derives the count encoding from its event lists
    (:func:`..ops.encodings.derive_count_input`, the loader's construction;
    ``res`` is required then), a rectified one from its raw coordinates
    ``event_raw_xy`` and its rectification index ``remap_idx``. The packed
    ``event_txy`` wire is not ported (ROADMAP.md, packed wire formats)."""
    if "event_txy" in window:
        raise NotImplementedError(
            "the packed event_txy window wire is not ported yet; see "
            "ROADMAP.md (packed wire formats)")
    net = window.get("net_input")
    if net is None:
        if res is None:
            raise ValueError("a window without net_input needs res")
        net = derive_count_input(window["event_list"], res,
                                 raw_xy=window.get("event_raw_xy"),
                                 remap_idx=window.get("remap_idx"))
    return {
        "net_input": net.float(),
        "event_list": window["event_list"],
        "pol_mask": window["pol_mask"].float(),
        "grad_mask": window["grad_mask"].float(),
    }


def run_passes(model, carry, xs, flow_scaling: float = 32.0):
    """The recurrent forward over pass-stacked inputs ``xs [P, B, H, W, C]``
    (the JAX step's ``lax.scan``): ``(flows [P, S, B, H, W, 2] x
    flow_scaling, carry)``, with grad wherever the caller's mode has it."""
    flows = []
    for x in xs:
        f, carry = model(x, carry)
        flows.append(f * flow_scaling)
    return torch.stack(flows), carry


def make_train_step(model, optimizer, loss_cfg: LossConfig,
                    warping: str = "Iterative", flow_scaling: float = 32.0,
                    res: Optional[tuple] = None) -> Callable:
    """Build the window step (``step.py:100-152``). Returned signature::

        new_state, loss = step(state, window)

    with ``window`` a dict of pass-stacked tensors on the model's device:

      * ``net_input``: ``[P, B, H, W, C]`` (optional, see
        :func:`unpack_window`)
      * ``event_list``: ``[P, B, N, 4]`` (ts, y, x, p), ts in [0, 1]
      * ``pol_mask``: ``[P, B, N, 2]``
      * ``grad_mask``: ``[P, B, N, 1]``

    The step updates the model's parameters and the optimizer's state in
    place; ``loss`` is a detached scalar tensor (reading it syncs).
    """
    loss_fn = LOSS_REGISTRY[warping]
    params = [p for p in model.parameters() if p.requires_grad]

    def step(state: TrainState, raw_window: Dict[str, torch.Tensor]):
        window = unpack_window(raw_window, res=res)
        for p in params:
            p.grad = None
        with torch.enable_grad():
            flows, carry = run_passes(model, state.carry,
                                      window["net_input"], flow_scaling)
            loss = loss_fn(flows, window["event_list"], window["pol_mask"],
                           window["grad_mask"], loss_cfg)
            loss.backward()
        optimizer.step()
        carry = tuple(c.detach() for c in carry)
        return TrainState(carry, state.step + 1), loss.detach()

    return step


def _cast_model(model, dtype):
    return model if dtype is None else copy.deepcopy(model).to(dtype)


def _cast(carry, x, dtype):
    if dtype is None:
        return carry, x
    return tuple(c.to(dtype) for c in carry), x.to(dtype)


def _derive_inputs(res, ev, x, pol, emask, raw=None, ridx=None):
    """Inputs left at ``None`` derive from the event list, as the loader
    builds them: the count encoding (from the raw coordinates ``raw`` and
    the rectification index ``ridx`` of a rectified sequence, when given),
    ``[p > 0, p < 0]`` polarity masks, and the event mask ``counts > 0``
    of the (remapped) counts."""
    if x is None:
        x = derive_count_input(ev, res, raw_xy=raw, remap_idx=ridx)
    x = x.float()
    if pol is None:
        p = ev[..., 3]
        pol = torch.stack([p > 0, p < 0], dim=-1)
    pol = pol.float()
    if emask is None:
        emask = (x.sum(-1, keepdim=True) > 0).float()
    return x, pol, emask


def make_forward_fn(model, flow_scaling: float = 32.0) -> Callable:
    """Single-pass inference: ``(carry, x) -> (flows, carry)``."""

    @torch.inference_mode()
    def forward(carry, x):
        flows, new_carry = model(x, carry)
        return flows * flow_scaling, new_carry

    return forward


def make_eval_step(model, val, flow_scaling: float = 32.0,
                   inference_dtype=None,
                   extras: Optional[Callable] = None) -> Callable:
    """One pass: model forward + validation update. Returned signature::

        vstate, carry, flow_fine = step(vstate, carry, x, ev, pol, emask,
                                        n_active=k)

    ``x``/``pol``/``emask`` may be ``None`` (derived from ``ev``, and for a
    rectified sequence from its raw coordinates ``raw [B, N, 2]`` and its
    rectification index ``ridx``). With ``with_extras=True`` (and
    ``extras`` given) a 4th value ``extras(vstate, aux)`` comes back: the
    window-boundary quantities.
    """
    net = _cast_model(model, inference_dtype)

    @torch.inference_mode()
    def step(vstate, carry, x, ev, pol, emask, n_active, aux=None,
             with_extras=False, raw=None, ridx=None):
        x, pol, emask = _derive_inputs(val.cfg.res, ev, x, pol, emask, raw,
                                       ridx)
        c, xin = _cast(carry, x, inference_dtype)
        flows, new_carry = net(xin, c)
        flow_fine = flows[-1].float() * flow_scaling
        vs = val.update(vstate, flow_fine, ev, pol, emask, n_active=n_active)
        if with_extras and extras is not None:
            return vs, new_carry, flow_fine, extras(vs, aux)
        return vs, new_carry, flow_fine

    return step


def make_eval_window_step(model, val, flow_scaling: float = 32.0,
                          inference_dtype=None, reset_first: bool = False,
                          extras: Optional[Callable] = None) -> Callable:
    """All P passes of a window (forward + update each, with the same
    ``n_active`` slot slicing as P calls of :func:`make_eval_step`)::

        vstate, carry, flow_fine_last = window(vstate, carry, xs, evs,
                                               pols, emasks)

    with pass-stacked ``xs [P,B,H,W,C]``, ``evs [P,B,N,4]``,
    ``pols [P,B,N,2]``, ``emasks [P,B,H,W,1]`` (any but ``evs`` may be
    ``None``; a rectified window derives from ``raw [P,B,N,2]`` and
    ``ridx``, see :func:`make_eval_step`). ``reset_first`` resets
    ``vstate`` before the first pass; ``extras(vstate, aux)`` adds a 4th
    return value.
    """
    net = _cast_model(model, inference_dtype)
    passes = val.cfg.passes

    @torch.inference_mode()
    def window(vstate, carry, xs, evs, pols, emasks, aux=None, raw=None,
               ridx=None):
        if reset_first:
            vstate = val.reset(vstate)
        xs, pols, emasks = _derive_inputs(val.cfg.res, evs, xs, pols, emasks,
                                          raw, ridx)
        flow_fine = None
        for k in range(passes):
            c, x = _cast(carry, xs[k], inference_dtype)
            flows, carry = net(x, c)
            flow_fine = flows[-1].float() * flow_scaling
            vstate = val.update(vstate, flow_fine, evs[k], pols[k],
                                emasks[k], n_active=k + 1)
        if extras is not None:
            return vstate, carry, flow_fine, extras(vstate, aux)
        return vstate, carry, flow_fine

    return window


def reset_carry(carry, reset_mask):
    """Zero the recurrent state of the batch lanes flagged in
    ``reset_mask [B]`` (bool)."""
    return tuple(
        torch.where(reset_mask.view((-1,) + (1,) * (c.dim() - 1)),
                    torch.zeros_like(c), c)
        for c in carry)

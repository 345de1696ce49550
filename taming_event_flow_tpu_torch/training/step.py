"""Eval steps: the inference half of ``taming_event_flow_tpu/training/step.py``.

The JAX builders return jitted programs; here they return plain closures
that run eagerly under ``torch.inference_mode()``. The model holds its own
weights, so no ``params`` argument travels with each call.

``inference_dtype`` (e.g. ``torch.bfloat16``) is the JAX package's contract
(``step.py:225-235, 349-358``): the model, the carry and the input are cast
to it for the forward pass, and the flow is cast back to float32 before the
validation update, which stays float32. The builders cast a copy of the
model once, so later changes to the caller's model do not reach a built
step.
"""

from __future__ import annotations

import copy
from typing import Callable, Optional

import torch

from ..ops.encodings import derive_count_input


def _cast_model(model, dtype):
    return model if dtype is None else copy.deepcopy(model).to(dtype)


def _cast(carry, x, dtype):
    if dtype is None:
        return carry, x
    return tuple(c.to(dtype) for c in carry), x.to(dtype)


def _derive_inputs(res, ev, x, pol, emask):
    """Inputs left at ``None`` derive from the event list, as the loader
    builds them: the count encoding, ``[p > 0, p < 0]`` polarity masks, and
    the event mask ``counts > 0``."""
    if x is None:
        x = derive_count_input(ev, res)
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

    ``x``/``pol``/``emask`` may be ``None`` (derived from ``ev``). With
    ``with_extras=True`` (and ``extras`` given) a 4th value
    ``extras(vstate, aux)`` comes back: the window-boundary quantities.
    """
    net = _cast_model(model, inference_dtype)

    @torch.inference_mode()
    def step(vstate, carry, x, ev, pol, emask, n_active, aux=None,
             with_extras=False):
        x, pol, emask = _derive_inputs(val.cfg.res, ev, x, pol, emask)
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
    ``None``). ``reset_first`` resets ``vstate`` before the first pass;
    ``extras(vstate, aux)`` adds a 4th return value.
    """
    net = _cast_model(model, inference_dtype)
    passes = val.cfg.passes

    @torch.inference_mode()
    def window(vstate, carry, xs, evs, pols, emasks, aux=None):
        if reset_first:
            vstate = val.reset(vstate)
        xs, pols, emasks = _derive_inputs(val.cfg.res, evs, xs, pols, emasks)
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

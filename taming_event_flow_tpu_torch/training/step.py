"""Training and eval steps: the PyTorch counterpart of
``taming_event_flow_tpu/training/step.py``.

The JAX builders return jitted pure programs; here they return plain
closures that run eagerly, apart from the train step and the eval window
step on the card, which replay their device work as CUDA graphs
(:mod:`.graphed`). The model holds its own weights and the optimizer its
own moments, so no ``params`` or ``opt_state`` travels with each call: the
train step updates both in place and returns a :class:`TrainState` of what
does travel, the recurrent carry and the step count.

Training (:func:`make_train_step`): P passes with grad enabled, the
contrast-max loss of ``LOSS_REGISTRY`` (Iterative or Linear) on the
stacked flows, one backward through all passes and the warp, a global-norm
clip and the optimizer update. The carry handed to the next window is
detached: truncated BPTT at the window edge, as the JAX step's pure carry
is (reference ``models/model.py:50-60``).

Modes: a train step puts a model left in eval mode back in training mode,
and the eval steps run an eval-mode copy of the model's modules
(:func:`_eval_net`) and never switch the caller's model, so one model
object can alternate training steps and eval passes and get each right
where a layer computes differently in the two (E-RAFT's BatchNorm,
``models/eraft.py``). Switching a mode walks every module (a quarter of a
millisecond for RecEVFlowNet), so neither step switches one on every call.

Eval (:func:`make_eval_step`, :func:`make_eval_window_step`) runs under
``torch.inference_mode()``. ``inference_dtype`` (e.g. ``torch.bfloat16``)
is the JAX package's contract (``step.py:225-235, 349-358``): the model,
the carry and the input are cast to it for the forward pass, and the flow is
cast back to float32 before the validation update, which stays float32. The
builders cast a copy of the model once, so later changes to the caller's
model do not reach a built step; without a cast the step's copy shares the
caller's parameters and buffers, and in-place changes to them do. With an
event mesh (``parallel/eval.py``) the eval steps derive the inputs from the
whole event list on every rank (the count input and the event mask see
every event, as the replicated model and AEE's mask must), then keep this
rank's N / E events for the update.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..objectives import LOSS_REGISTRY, LossConfig
from ..ops.encodings import derive_count_input, unpack_event_wire
from ..utils.device import resolve_device
from ..utils.diagnostics import annotate
from . import graphed


class TrainState(NamedTuple):
    """What one train step hands the next: the model's recurrent carry
    (detached, ``[B, ...]`` NCHW maps; ``()`` for a stateless model) and
    the number of steps taken."""

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
    """The window a train step consumes (``step.py:53-97``): the packed
    ``event_txy`` wire (``training.window.stack_window(packed=True)``)
    restored to the plain window, and everything cast to float32 where the
    wire narrows it (a no-op for a plain float32 window). The packed wire
    is exact: the int8 polarity is +-1 or 0, ``pol_mask`` is its ``[p > 0,
    p < 0]``, the loader's own construction, and a narrowed count input
    holds integers. A window without ``net_input`` derives the count
    encoding from its event lists (:func:`..ops.encodings.
    derive_count_input`, the loader's construction; ``res`` is required
    then), a rectified one from its raw coordinates ``event_raw_xy`` and
    its rectification index ``remap_idx``."""
    if "event_txy" in window:
        p = window["event_p"].float()
        window = {
            "net_input": window.get("net_input"),
            "event_list": torch.cat([window["event_txy"], p[..., None]],
                                    dim=-1),
            "pol_mask": torch.stack([p > 0, p < 0], dim=-1),
            "grad_mask": window["grad_mask"],
            "event_raw_xy": window.get("event_raw_xy"),
            "remap_idx": window.get("remap_idx"),
        }
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
    place; ``loss`` is a detached scalar tensor (reading it syncs). On the
    card the unpack, the passes, the loss and the backward run as a CUDA
    graph from a window signature's second call on (:mod:`.graphed`: the
    first runs eagerly; the optimizer always does); on the CPU the step
    runs eagerly. ``step.eager`` runs a step eagerly on either; a replay
    runs the kernels the eager step launches, so both give the same bits.

    Each call puts a model whose mode flag reads eval back in training mode
    first (``model.train()``; a submodule the caller set to eval inside a
    model in training mode stays so).

    While a profile is active the step records the span ``train.step``
    (rid: the state's step count) with the children ``train.forward``
    (unpack and the P passes), ``train.loss``, ``train.backward`` and
    ``train.optimizer`` (the clip and the update) when it runs eagerly, and
    ``train.replay`` (with ``train.capture`` before it on a capture) and
    ``train.optimizer`` when it replays.
    """
    loss_fn = LOSS_REGISTRY[warping]
    params = [p for p in model.parameters() if p.requires_grad]

    def device_work(carry, raw_window):
        with annotate("train.forward"):
            window = unpack_window(raw_window, res=res)
            for p in params:
                p.grad = None
            with torch.enable_grad():
                flows, carry = run_passes(model, carry,
                                          window["net_input"], flow_scaling)
        with torch.enable_grad():
            with annotate("train.loss"):
                loss = loss_fn(flows, window["event_list"],
                               window["pol_mask"], window["grad_mask"],
                               loss_cfg)
            with annotate("train.backward"):
                loss.backward()
        return loss.detach(), tuple(c.detach() for c in carry)

    def bind_grads(out):
        # a replay binds every p.grad to the gradients of the graph that
        # ran, so that an interleaved eager step or another graph cannot
        # hand the optimizer stale ones (a capture starts with them None,
        # so the graph owns its gradient buffers)
        loss, carry, grads = out
        for p, grad in zip(params, grads):
            p.grad = grad
        return graphed.clones((loss, carry))

    graphs = graphed.StepGraphs(
        "train", lambda carry, raw_window: device_work(carry, raw_window)
        + ([p.grad for p in params],), bind_grads)

    def run(state: TrainState, raw_window, use_graphs: bool):
        if not model.training:
            model.train()
        with annotate("train.step", rid=state.step):
            out = graphs(state.carry, raw_window) if use_graphs else None
            if out is None:
                out = device_work(state.carry, raw_window)
            with annotate("train.optimizer"):
                optimizer.step()
        loss, carry = out
        return TrainState(carry, state.step + 1), loss

    def step(state: TrainState, raw_window: Dict[str, torch.Tensor]):
        return run(state, raw_window, graphed.uses_graphs(params))

    step.eager = lambda state, raw_window: run(state, raw_window, False)
    step.graphs = graphs
    return step


def _eval_net(model, dtype=None):
    """The model an eval step runs, in eval mode whatever mode the caller's
    model is in or takes later: with ``dtype``, a copy cast to it; without,
    a copy of the modules alone, sharing the caller's parameters and
    buffers."""
    if dtype is not None:
        return copy.deepcopy(model).to(dtype).eval()
    shared = {id(t): t for t in itertools.chain(model.parameters(),
                                                model.buffers())}
    return copy.deepcopy(model, shared).eval()


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
    """Single-pass inference: ``(carry, x) -> (flows, carry)``, in eval
    mode (:func:`_eval_net`)."""
    net = _eval_net(model)

    @torch.inference_mode()
    def forward(carry, x):
        flows, new_carry = net(x, carry)
        return flows * flow_scaling, new_carry

    return forward


def make_eval_step(model, val, flow_scaling: float = 32.0,
                   inference_dtype=None,
                   extras: Optional[Callable] = None,
                   mesh=None) -> Callable:
    """One pass: model forward + validation update. Returned signature::

        vstate, carry, flow_fine = step(vstate, carry, x, ev, pol, emask,
                                        n_active=k)

    ``x``/``pol``/``emask`` may be ``None`` (derived from ``ev``, and for a
    rectified sequence from its raw coordinates ``raw [B, N, 2]`` and its
    rectification index ``ridx``). With ``with_extras=True`` (and
    ``extras`` given) a 4th value ``extras(vstate, aux)`` comes back: the
    window-boundary quantities. With an event ``mesh`` the update takes
    this rank's share of ``ev`` and ``pol`` (``val`` holds N / E slots).
    """
    net = _eval_net(model, inference_dtype)
    if mesh is not None:
        from ..parallel.eval import shard_eval_batch

    @torch.inference_mode()
    def step(vstate, carry, x, ev, pol, emask, n_active, aux=None,
             with_extras=False, raw=None, ridx=None):
        x, pol, emask = _derive_inputs(val.cfg.res, ev, x, pol, emask, raw,
                                       ridx)
        if mesh is not None:
            ev, pol = shard_eval_batch(ev, pol, mesh)
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
                          extras: Optional[Callable] = None,
                          mesh=None) -> Callable:
    """All P passes of a window (forward + update each, with the same
    ``n_active`` slot slicing as P calls of :func:`make_eval_step`)::

        vstate, carry, flow_fine_last = window(vstate, carry, xs, evs,
                                               pols, emasks)

    with pass-stacked ``xs [P,B,H,W,C]``, ``evs [P,B,N,4]``,
    ``pols [P,B,N,2]``, ``emasks [P,B,H,W,1]`` (any but ``evs`` may be
    ``None``; a rectified window derives from ``raw [P,B,N,2]`` and
    ``ridx``, see :func:`make_eval_step`). ``evs`` may be the u32 event
    wire, ``{"ts" [P,B,N], "yxp" [P,B,N][, "rect" [H,W,2]]}``
    (:func:`..ops.encodings.unpack_event_wire`); with ``rect`` the count
    input derives from the unpacked raw coordinates. ``reset_first`` resets
    ``vstate`` before the first pass; ``extras(vstate, aux)`` adds a 4th
    return value; ``mesh`` as in :func:`make_eval_step`.

    On the card, without a mesh, the window runs as a CUDA graph from an
    input signature's second call on (:mod:`.graphed`: the first runs
    eagerly); with a mesh (its reducers and shards run collectives) and on
    the CPU it runs eagerly. ``window.eager`` runs a window eagerly on
    either; a replay runs the kernels the eager window launches, so both
    give the same bits. A replayed window updates the graph's own state
    buffers and hands them back as ``vstate`` (the next window resets and
    rewrites them), and clones of the carry, the flow and the ``extras``,
    which a reader may still hold while the next window replays. While a
    profile is active a replayed window records ``eval.replay`` (with
    ``eval.capture`` before it on a capture) in place of the model's spans.
    """
    net = _eval_net(model, inference_dtype)
    params = list(net.parameters())
    passes = val.cfg.passes
    if mesh is not None:
        from ..parallel.eval import shard_eval_window

    @torch.inference_mode()
    def body(vstate, carry, xs, evs, pols, emasks, aux=None, raw=None,
             ridx=None):
        if reset_first:
            vstate = val.reset(vstate)
        if isinstance(evs, dict):
            # the u32 event wire: a rectified window's coordinates come
            # from the sequence's forward map, and its count input from
            # the raw integers
            rect = evs.get("rect")
            evs, raw_yx = unpack_event_wire(evs["ts"], evs["yxp"], rect)
            if rect is not None:
                raw = raw_yx
        xs, pols, emasks = _derive_inputs(val.cfg.res, evs, xs, pols, emasks,
                                          raw, ridx)
        if mesh is not None:
            evs, pols = shard_eval_window(evs, pols, mesh)
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

    graphs = graphed.StepGraphs(
        "eval", body, lambda out: (out[0],) + graphed.clones(out[1:]))

    @torch.inference_mode()
    def window(vstate, carry, xs, evs, pols, emasks, aux=None, raw=None,
               ridx=None):
        if mesh is None and graphed.uses_graphs(params):
            if reset_first:
                # the reset restarts the state's pass count: no graph keys
                # on the count it came with
                vstate = dataclasses.replace(vstate, pass_idx=0)
            out = graphs(vstate, carry, xs, evs, pols, emasks, aux, raw,
                         ridx)
            if out is not None:
                return out
        return body(vstate, carry, xs, evs, pols, emasks, aux, raw, ridx)

    window.eager = body
    window.graphs = graphs
    return window


def reset_carry(carry, reset_mask):
    """Zero the recurrent state of the batch lanes flagged in
    ``reset_mask [B]`` (bool)."""
    return tuple(
        torch.where(reset_mask.view((-1,) + (1,) * (c.dim() - 1)),
                    torch.zeros_like(c), c)
        for c in carry)

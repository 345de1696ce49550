"""RecEVFlowNet as plain functions of a parameter dict, with its shapes,
its init scales and its convolutions.

Frozen copy of ``taming_event_flow_tpu_torch/models/model.py``
(``RecEVFlowNet``, ``pad_to_multiple``, ``_upsampled``), ``models/unet.py``
(``MultiResUNetRecurrent``) and ``models/blocks.py`` (``ConvLayer``,
``ConvGRU``, ``RecurrentConvLayer``, ``ResidualBlock``,
``UpsampleConvLayer``) at commit 96ab861, for the options in
:data:`FIXED`: ``skip_type: sum``, ``norm: None``, the upsample-conv
decoder, ReLU feed-forward activations, a tanh head
(:func:`reference.models.lookup` refuses any other).

Departures: the decoders' bilinear upsampling is ``F.interpolate`` with
autograd's backward, where the port has a gather-form backward
(``ops/resize.py``); the forward is the same. ``dtype`` casts the
parameters, the input and the carry for the forward, as the port's eval
steps cast a copy of the model (``training/step.py: _cast_model``); the
predictions leave in float32. ``quant``, when given, transforms every
convolution's input and weight first: the benchmark's controls use it to
compute the reference in a lower precision than the configuration's, and
its witness to lay the operands out channels-last.

Init scales (the model's own init ranges, every weight uniform;
:func:`init_bounds`):

* a feed-forward conv ``W [out, in, k, k]``: ``+-sqrt(1 / in)``, bias zero;
  a prediction head ``+-final_w_scale`` when the config sets one;
* a ConvGRU gate (``*_gate.weight``): ``+-sqrt(3 / (in k k))``, the
  per-element variance of an orthogonal ``[out, in k k]`` matrix with unit
  rows, bias zero;
* a residual conv (``conv1``, ``conv2``): ``+-1 / sqrt(in k k)`` for the
  weight and the bias (torch's own Conv2d default).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F


FIXED = {"skip_type": "sum", "norm": None, "use_upsample_conv": True,
         "final_activation": "tanh"}
NUMBERS = ("num_bins", "base_channels", "num_encoders",
           "num_residual_blocks", "kernel_size", "channel_multiplier",
           "final_w_scale")
N_OUT = 2


def _widths(cfg: Dict):
    """(encoder inputs, encoder outputs) in channels."""
    base, mult = cfg["base_channels"], cfg["channel_multiplier"]
    n_enc = cfg["num_encoders"]
    return ([int(base * mult ** (i - 1)) for i in range(n_enc)],
            [int(base * mult ** i) for i in range(n_enc)])


def weight_shapes(cfg: Dict) -> Dict[str, tuple]:
    """Name -> shape of every parameter with ``cfg``'s widths, in the
    port's state_dict naming (computed, not read from the program)."""
    k = cfg["kernel_size"]
    cin = cfg.get("num_bins", 2)
    ins, outs = _widths(cfg)
    shapes = {}
    for i, out in enumerate(outs):
        pre = f"arch.encoders.{i}"
        shapes[f"{pre}.conv.conv2d.weight"] = (out, cin, k, k)
        shapes[f"{pre}.conv.conv2d.bias"] = (out,)
        for gate in ("reset_gate", "update_gate", "out_gate"):
            shapes[f"{pre}.recurrent_block.{gate}.weight"] = (out, 2 * out,
                                                              3, 3)
            shapes[f"{pre}.recurrent_block.{gate}.bias"] = (out,)
        cin = out
    for r in range(cfg["num_residual_blocks"]):
        for conv in ("conv1", "conv2"):
            shapes[f"arch.resblocks.{r}.{conv}.weight"] = (cin, cin, k, k)
            shapes[f"arch.resblocks.{r}.{conv}.bias"] = (cin,)
    for i, out in enumerate(reversed(ins)):
        dec_in = cin + (N_OUT if i > 0 else 0)
        shapes[f"arch.decoders.{i}.conv2d.weight"] = (out, dec_in, k, k)
        shapes[f"arch.decoders.{i}.conv2d.bias"] = (out,)
        shapes[f"arch.preds.{i}.conv2d.weight"] = (N_OUT, out, 1, 1)
        shapes[f"arch.preds.{i}.conv2d.bias"] = (N_OUT,)
        cin = out
    return shapes


def init_bounds(name: str, shape: tuple, cfg: Dict):
    """``(weight bound, bias bound)`` of the layer whose weight ``name``
    is; ``None`` for a bias (its layer's weight gives it)."""
    if name.endswith(".bias"):
        return None
    fan_in = shape[1] * shape[2] * shape[3]
    if "_gate." in name:
        return math.sqrt(3.0 / fan_in), 0.0
    if ".resblocks." in name:
        b = 1.0 / math.sqrt(fan_in)
        return b, b
    if ".preds." in name and cfg.get("final_w_scale") is not None:
        return float(cfg["final_w_scale"]), 0.0
    return math.sqrt(1.0 / shape[1]), 0.0


def _padded(n: int) -> int:
    return n + (16 - n % 16) % 16


def conv_layers(cfg: Dict, height: int, width: int) -> List[tuple]:
    """Every convolution of one pass at an ``H x W`` input: ``(c_in,
    c_out, k, h_out, w_out, first)``, ``first`` marking the one whose input
    is the network input."""
    k = cfg["kernel_size"]
    cin = cfg.get("num_bins", 2)
    h, w = _padded(height), _padded(width)
    ins, outs = _widths(cfg)
    layers = []
    for i, out in enumerate(outs):
        h = (h + 2 * (k // 2) - k) // 2 + 1
        w = (w + 2 * (k // 2) - k) // 2 + 1
        layers.append((cin, out, k, h, w, i == 0))
        layers += [(2 * out, out, 3, h, w, False)] * 3  # the ConvGRU gates
        cin = out
    layers += [(cin, cin, k, h, w, False)] * (
        2 * cfg["num_residual_blocks"])
    for i, out in enumerate(reversed(ins)):
        dec_in = cin + (N_OUT if i > 0 else 0)
        h, w = h * 2, w * 2
        layers.append((dec_in, out, k, h, w, False))
        layers.append((out, N_OUT, 1, h, w, False))
        cin = out
    return layers

def _conv(p, name, x, stride=1, quant=None):
    w, b = p[name + ".weight"], p[name + ".bias"]
    if quant is not None:
        x, w = quant(x), quant(w)
    return F.conv2d(x, w, b, stride=stride, padding=w.shape[-1] // 2)


def _up2(x):
    return F.interpolate(x, size=(x.shape[2] * 2, x.shape[3] * 2),
                         mode="bilinear", align_corners=False)


def _gru(p, pre, x, h, quant):
    stacked = torch.cat([x, h], dim=1)
    update = torch.sigmoid(_conv(p, pre + ".update_gate", stacked,
                                 quant=quant))
    reset = torch.sigmoid(_conv(p, pre + ".reset_gate", stacked, quant=quant))
    out = torch.tanh(_conv(p, pre + ".out_gate",
                           torch.cat([x, h * reset], dim=1), quant=quant))
    return h * (1.0 - update) + out * update


def init_state(cfg: Dict, batch, height, width, dtype=torch.float32,
               device=None):
    """Zero carry: one ``[B, C_i, h_i, w_i]`` map per encoder, at the
    input padded to a multiple of 16."""
    height += (16 - height % 16) % 16
    width += (16 - width % 16) % 16
    k = cfg["kernel_size"]
    out = []
    for i in range(cfg["num_encoders"]):
        height = (height + 2 * (k // 2) - k) // 2 + 1
        width = (width + 2 * (k // 2) - k) // 2 + 1
        ch = int(cfg["base_channels"] * cfg["channel_multiplier"] ** i)
        out.append(torch.zeros(batch, ch, height, width, dtype=dtype,
                               device=device))
    return tuple(out)


def forward(params: Dict[str, torch.Tensor], cfg: Dict, x, state,
            dtype: Optional[torch.dtype] = None,
            quant: Optional[Callable] = None, finest_only: bool = False):
    """One pass: ``x [B, H, W, C]`` and the carry -> ``(flows [S, B, H, W,
    2] float32, new carry)`` (``finest_only``: ``[1, B, H, W, 2]``, the
    finest scale alone). Flow values are the head's, before
    ``flow_scaling``."""
    p = params
    if dtype is not None:
        p = {k: v.to(dtype) for k, v in params.items()}
        x = x.to(dtype)
        state = tuple(s.to(dtype) for s in state)
    n_enc = cfg["num_encoders"]
    h_in, w_in = x.shape[1], x.shape[2]
    ph, pw = (16 - h_in % 16) % 16, (16 - w_in % 16) % 16
    if ph or pw:
        x = F.pad(x, (0, 0, pw, 0, ph, 0))
    padded = x.shape[1:3]
    x = x.permute(0, 3, 1, 2).contiguous()

    blocks, new_state = [], []
    for i, h in enumerate(state):
        pre = f"arch.encoders.{i}"
        x = torch.relu(_conv(p, pre + ".conv.conv2d", x, stride=2,
                             quant=quant))
        x = _gru(p, pre + ".recurrent_block", x, h, quant)
        blocks.append(x)
        new_state.append(x)
    for r in range(cfg["num_residual_blocks"]):
        pre = f"arch.resblocks.{r}"
        out = torch.relu(_conv(p, pre + ".conv1", x, quant=quant))
        x = torch.relu(_conv(p, pre + ".conv2", out, quant=quant) + x)
    preds = []
    for i in range(n_enc):
        skip = blocks[n_enc - i - 1]
        x = x[:, :, : skip.shape[2], : skip.shape[3]] + skip
        if i > 0:
            prev = preds[-1][:, :, : x.shape[2], : x.shape[3]]
            x = torch.cat([prev, x], dim=1)
        x = torch.relu(_conv(p, f"arch.decoders.{i}.conv2d", _up2(x),
                             quant=quant))
        preds.append(torch.tanh(_conv(p, f"arch.preds.{i}.conv2d", x,
                                      quant=quant)))
    flows = []
    scales = range(n_enc - 1, n_enc) if finest_only else range(n_enc)
    for i in scales:
        flow = preds[i].float()
        factor = padded[0] // flow.shape[2]
        if factor != 1:
            flow = F.interpolate(flow, size=(flow.shape[2] * factor,
                                             flow.shape[3] * factor),
                                 mode="bilinear", align_corners=False)
        flow = (2 ** (n_enc - i - 1) * flow).permute(0, 2, 3, 1)
        flows.append(flow[:, ph:, pw:, :])
    return torch.stack(flows), tuple(new_state)

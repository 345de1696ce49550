"""NN building blocks (``nn.Module``, NCHW inside): the PyTorch counterpart
of ``taming_event_flow_tpu/models/blocks.py``.

Submodule names follow the reference torch state_dict
(``taming_event_flow_tpu/models/port.py:9-14``): ``conv2d`` inside conv
layers, ``reset_gate``/``update_gate``/``out_gate`` inside the ConvGRU,
``conv1``/``conv2`` inside residual blocks. Initialisation matches the JAX
package: feed-forward convs uniform ``+-sqrt(1 / in_channels)`` (or
``w_scale``) with zero bias, ConvGRU gates orthogonal with zero bias; all
of it drawn from an explicit ``torch.Generator`` (:func:`init_weights`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

_ACTIVATIONS = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    # flax's nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}


def get_activation(name: Optional[str]):
    return None if name is None else _ACTIVATIONS[name]


def _check_norm(norm):
    if norm is not None:
        raise NotImplementedError(
            f"norm={norm!r} is not ported yet (ROADMAP.md, registry variants)")


class ConvLayer(nn.Module):
    """Conv + optional activation (reference ``submodules.py:8-62``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1,
                 activation: Optional[str] = "relu", norm=None,
                 w_scale: Optional[float] = None):
        super().__init__()
        _check_norm(norm)
        self.conv2d = nn.Conv2d(in_channels, out_channels, kernel_size,
                                stride=stride, padding=kernel_size // 2)
        self.activation = get_activation(activation)
        self.w_scale = w_scale

    def init_weights(self, gen: torch.Generator):
        s = self.w_scale
        if s is None:
            s = math.sqrt(1.0 / self.conv2d.in_channels)
        nn.init.uniform_(self.conv2d.weight, -s, s, generator=gen)
        nn.init.zeros_(self.conv2d.bias)

    def forward(self, x):
        x = self.conv2d(x)
        return x if self.activation is None else self.activation(x)


class ConvGRU(nn.Module):
    """Convolutional GRU cell (reference ``submodules.py:111-152``)."""

    def __init__(self, input_size: int, hidden_size: int,
                 kernel_size: int = 3):
        super().__init__()
        pad = kernel_size // 2
        cin = input_size + hidden_size
        self.reset_gate = nn.Conv2d(cin, hidden_size, kernel_size, padding=pad)
        self.update_gate = nn.Conv2d(cin, hidden_size, kernel_size,
                                     padding=pad)
        self.out_gate = nn.Conv2d(cin, hidden_size, kernel_size, padding=pad)

    def init_weights(self, gen: torch.Generator):
        for gate in (self.reset_gate, self.update_gate, self.out_gate):
            # orthogonal over the flattened [out, in * k * k] matrix
            nn.init.orthogonal_(gate.weight, generator=gen)
            nn.init.zeros_(gate.bias)

    def forward(self, x, h):
        stacked = torch.cat([x, h], dim=1)
        update = torch.sigmoid(self.update_gate(stacked))
        reset = torch.sigmoid(self.reset_gate(stacked))
        out = torch.tanh(self.out_gate(torch.cat([x, h * reset], dim=1)))
        return h * (1.0 - update) + out * update


class RecurrentConvLayer(nn.Module):
    """Strided conv + ConvGRU (reference ``submodules.py:65-108``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 2,
                 activation_ff: Optional[str] = "relu", norm=None):
        super().__init__()
        self.conv = ConvLayer(in_channels, out_channels, kernel_size,
                              stride=stride, activation=activation_ff,
                              norm=norm)
        self.recurrent_block = ConvGRU(out_channels, out_channels, 3)

    def forward(self, x, h):
        h = self.recurrent_block(self.conv(x), h)
        return h, h


class ResidualBlock(nn.Module):
    """Two convs + identity shortcut (reference ``submodules.py:155-227``)."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 activation: Optional[str] = "relu", norm=None):
        super().__init__()
        _check_norm(norm)
        pad = kernel_size // 2
        self.conv1 = nn.Conv2d(channels, channels, kernel_size, padding=pad)
        self.conv2 = nn.Conv2d(channels, channels, kernel_size, padding=pad)
        self.activation = get_activation(activation)

    def init_weights(self, gen: torch.Generator):
        # torch's own Conv2d default (kaiming-uniform), from the generator
        for conv in (self.conv1, self.conv2):
            nn.init.kaiming_uniform_(conv.weight, a=math.sqrt(5),
                                     generator=gen)
            bound = 1.0 / math.sqrt(conv.weight[0].numel())
            nn.init.uniform_(conv.bias, -bound, bound, generator=gen)

    def forward(self, x):
        act = self.activation
        out = self.conv1(x)
        if act is not None:
            out = act(out)
        out = self.conv2(out) + x
        return out if act is None else act(out)


class UpsampleConvLayer(ConvLayer):
    """Bilinear x2 upsample (half-pixel centres, like ``jax.image.resize``)
    + conv (reference ``submodules.py:230-273``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, activation: Optional[str] = "relu",
                 norm=None):
        super().__init__(in_channels, out_channels, kernel_size, stride=1,
                         activation=activation, norm=norm)

    def forward(self, x):
        x = F.interpolate(x, scale_factor=2, mode="bilinear",
                          align_corners=False)
        return super().forward(x)


def init_weights(module: nn.Module, gen: torch.Generator) -> None:
    """Initialise every block of ``module`` from ``gen`` (module order)."""
    for m in module.modules():
        if hasattr(m, "init_weights") and m is not module:
            m.init_weights(gen)

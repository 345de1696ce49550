"""The FireFlowNet family (NCHW inside): the PyTorch counterpart of
``taming_event_flow_tpu/models/fire.py``.

A full-resolution stack with no downsampling and no padding. The recurrent
model runs head conv -> ConvGRU -> conv -> ConvGRU -> conv -> 1x1
prediction, the stateless one four convs and the prediction. The output has
one scale, ``[1, B, H, W, 2]`` in (x, y) order, so the losses and metrics
take it as they take RecEVFlowNet's flows. ``compute_dtype`` is
RecEVFlowNet's (:mod:`.model`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .blocks import ConvGRU, ConvLayer, set_compute_dtype


def _flow(pred):
    """``[B, 2, H, W]`` -> float32 ``[1, B, H, W, 2]``."""
    return pred.float().permute(0, 2, 3, 1)[None]


class RecFireFlowNet(nn.Module):
    """Recurrent FireFlowNet: two ConvGRU cells at full resolution. Its
    carry is the two cells' ``[B, C, H, W]`` hidden maps."""

    def __init__(self, num_bins: int = 2, base_channels: int = 32,
                 kernel_size: int = 3,
                 final_activation: Optional[str] = "tanh",
                 final_w_scale: Optional[float] = None,
                 compute_dtype: Optional[str] = None):
        super().__init__()
        c, k = base_channels, kernel_size
        self.base_channels = c
        self.head = ConvLayer(num_bins, c, k)
        self.gru1 = ConvGRU(c, c, k)
        self.conv1 = ConvLayer(c, c, k)
        self.gru2 = ConvGRU(c, c, k)
        self.conv2 = ConvLayer(c, c, k)
        self.pred = ConvLayer(c, 2, 1, activation=final_activation,
                              w_scale=final_w_scale)
        set_compute_dtype(self, compute_dtype)

    def forward(self, x, state):
        x = self.head(x.permute(0, 3, 1, 2).contiguous())
        h1 = self.gru1(x, state[0])
        h2 = self.gru2(self.conv1(h1), state[1])
        return _flow(self.pred(self.conv2(h2))), (h1, h2)

    def init_state(self, batch: int, height: int, width: int,
                   dtype=torch.float32, device=None):
        """Zero carry: two ``[batch, base_channels, height, width]`` maps."""
        return tuple(torch.zeros(batch, self.base_channels, height, width,
                                 dtype=dtype, device=device)
                     for _ in range(2))


class FireFlowNet(nn.Module):
    """Stateless FireFlowNet: the same stack without the GRUs. Its carry
    is ``()``."""

    def __init__(self, num_bins: int = 2, base_channels: int = 32,
                 kernel_size: int = 3,
                 final_activation: Optional[str] = "tanh",
                 final_w_scale: Optional[float] = None,
                 compute_dtype: Optional[str] = None):
        super().__init__()
        c, k = base_channels, kernel_size
        self.head = ConvLayer(num_bins, c, k)
        self.conv1 = ConvLayer(c, c, k)
        self.conv2 = ConvLayer(c, c, k)
        self.conv3 = ConvLayer(c, c, k)
        self.pred = ConvLayer(c, 2, 1, activation=final_activation,
                              w_scale=final_w_scale)
        set_compute_dtype(self, compute_dtype)

    def forward(self, x, state=()):
        x = x.permute(0, 3, 1, 2).contiguous()
        for conv in (self.head, self.conv1, self.conv2, self.conv3):
            x = conv(x)
        return _flow(self.pred(x)), ()

    def init_state(self, batch: int, height: int, width: int,
                   dtype=torch.float32, device=None):
        return ()

"""Multi-resolution UNets (NCHW inside): the PyTorch counterpart of
``taming_event_flow_tpu/models/unet.py`` (``MultiResUNetRecurrent`` and the
stateless ``MultiResUNet``).

The recurrent state is an explicit tuple of per-encoder hidden maps, NCHW
``[B, C_i, h_i, w_i]`` (the JAX carry holds the same maps NHWC).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .blocks import ConvLayer, RecurrentConvLayer, ResidualBlock, \
    TransposedConvLayer, UpsampleConvLayer


def encoder_channels(base_channels: int, num_encoders: int,
                     channel_multiplier: float):
    """Channel schedule (reference ``arch.py:60-67``)."""
    ins = [int(base_channels * channel_multiplier ** (i - 1))
           for i in range(num_encoders)]
    outs = [int(base_channels * channel_multiplier**i)
            for i in range(num_encoders)]
    return ins, outs


def _crop_to(x, y):
    """Crop ``x`` to ``y``'s spatial size (odd-dimension skips)."""
    if x.shape[2:] != y.shape[2:]:
        x = x[:, :, : y.shape[2], : y.shape[3]]
    return x


class _MultiResUNet(nn.Module):
    """The two UNets' shared body (reference ``arch.py:6-195``):
    ``num_encoders`` strided encoders (``encoder`` builds each), the
    residual bottleneck and the multi-res decoder, whose previous-scale
    prediction is concatenated into the next decoder's input. Each decoder
    upsamples bilinearly and convolves (``use_upsample_conv``, the
    default) or is a stride-2 transposed conv."""

    def __init__(self, encoder, num_bins: int = 2, base_channels: int = 64,
                 num_encoders: int = 4, num_residual_blocks: int = 2,
                 num_output_channels: int = 2, skip_type: str = "sum",
                 norm=None, use_upsample_conv: bool = True,
                 kernel_size: int = 3, encoder_stride: int = 2,
                 channel_multiplier: float = 2,
                 final_activation: Optional[str] = "tanh",
                 final_w_scale: Optional[float] = None,
                 ff_act: Optional[str] = "relu"):
        super().__init__()
        if skip_type not in ("sum", "concat"):
            raise ValueError(f"Unknown skip_type {skip_type!r}")
        self.skip_type = skip_type
        self.kernel_size = kernel_size
        self.encoder_stride = encoder_stride
        ins, outs = encoder_channels(base_channels, num_encoders,
                                     channel_multiplier)
        self.outs = outs
        self.encoders = nn.ModuleList()
        cin = num_bins
        for out_ch in outs:
            self.encoders.append(encoder(
                cin, out_ch, kernel_size, stride=encoder_stride,
                activation=ff_act, norm=norm))
            cin = out_ch
        self.resblocks = nn.ModuleList(
            ResidualBlock(outs[-1], activation=ff_act, norm=norm)
            for _ in range(num_residual_blocks))
        up_type = (UpsampleConvLayer if use_upsample_conv
                   else TransposedConvLayer)
        self.decoders = nn.ModuleList()
        self.preds = nn.ModuleList()
        for i, out_ch in enumerate(reversed(ins)):
            dec_in = cin + (outs[num_encoders - i - 1]
                            if skip_type == "concat" else 0)
            if i > 0:
                dec_in += num_output_channels
            self.decoders.append(up_type(
                dec_in, out_ch, kernel_size, activation=ff_act, norm=norm))
            self.preds.append(ConvLayer(
                out_ch, num_output_channels, kernel_size=1,
                activation=final_activation, norm=norm,
                w_scale=final_w_scale))
            cin = out_ch

    def _decode(self, x, blocks):
        for res in self.resblocks:
            x = res(x)
        predictions = []
        n = len(self.encoders)
        for i, (dec, pred) in enumerate(zip(self.decoders, self.preds)):
            skip = blocks[n - i - 1]
            x = _crop_to(x, skip)
            x = x + skip if self.skip_type == "sum" else torch.cat(
                [x, skip], dim=1)
            if i > 0:
                x = torch.cat([_crop_to(predictions[-1], x), x], dim=1)
            x = dec(x)
            # predictions stay in the compute dtype inside the loop and
            # leave as float32, as in the JAX package
            predictions.append(pred(x))
        return [p.float() for p in predictions]


def _recurrent_encoder(cin, cout, kernel_size, stride, activation, norm):
    return RecurrentConvLayer(cin, cout, kernel_size, stride=stride,
                              activation_ff=activation, norm=norm)


class MultiResUNetRecurrent(_MultiResUNet):
    """Recurrent multi-res UNet (reference ``arch.py:197-242``): each
    encoder is a strided conv and a ConvGRU.

    ``forward(x, state) -> (predictions, new_state)``: ``predictions`` is a
    coarse-to-fine list of float32 ``[B, out, h_i, w_i]`` maps.
    """

    def __init__(self, **kwargs):
        super().__init__(_recurrent_encoder, **kwargs)

    def forward(self, x, state):
        blocks, new_state = [], []
        for enc, h in zip(self.encoders, state):
            x, h = enc(x, h)
            blocks.append(x)
            new_state.append(h)
        return self._decode(x, blocks), tuple(new_state)

    def init_state(self, batch: int, height: int, width: int,
                   dtype=torch.float32, device=None) -> Tuple:
        """Zero carry for a (padded) ``[batch, ..., height, width]`` input."""
        state = []
        h, w = height, width
        k, s = self.kernel_size, self.encoder_stride
        for out_ch in self.outs:
            h = (h + 2 * (k // 2) - k) // s + 1
            w = (w + 2 * (k // 2) - k) // s + 1
            state.append(torch.zeros(batch, out_ch, h, w, dtype=dtype,
                                     device=device))
        return tuple(state)


class MultiResUNet(_MultiResUNet):
    """Stateless multi-res UNet (``taming_event_flow_tpu/models/unet.py:
    MultiResUNet``): each encoder is one strided conv, the decode path is
    the recurrent one's. ``forward(x) -> predictions``."""

    def __init__(self, **kwargs):
        super().__init__(ConvLayer, **kwargs)

    def forward(self, x):
        blocks = []
        for enc in self.encoders:
            x = enc(x)
            blocks.append(x)
        return self._decode(x, blocks)

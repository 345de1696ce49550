"""NN building blocks (``nn.Module``, NCHW inside): the PyTorch counterpart
of ``taming_event_flow_tpu/models/blocks.py``.

Submodule names follow the reference torch state_dict
(``taming_event_flow_tpu/models/port.py:9-14``): ``conv2d`` and
``norm_layer`` inside conv layers, ``reset_gate``/``update_gate``/
``out_gate`` inside the ConvGRU, ``conv1``/``conv2`` inside residual
blocks, ``transposed_conv2d`` inside a transposed-conv decoder.
Initialisation matches the JAX package: feed-forward convs uniform
``+-sqrt(1 / in_channels)`` (or ``w_scale``) with zero bias, ConvGRU gates
orthogonal with zero bias, transposed convs lecun-normal with zero bias,
norm scale one and bias zero; all of it drawn from an explicit
``torch.Generator`` (:func:`init_weights`).

Every convolution is a :class:`Conv2d` or a :class:`ConvTranspose2d`,
which follow Flax's ``dtype``: with a compute dtype set
(:func:`set_compute_dtype`, the model's ``compute_dtype``) they cast their
input, weight and bias to it and return that dtype, the parameters staying
float32; the elementwise ops around them then follow type promotion, as
JAX's do.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import upsample_bilinear

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
    if norm == "BN":
        raise NotImplementedError(
            "norm='BN' is not ported: the JAX trainer cannot train it "
            "(ROADMAP.md, section 3)")
    if norm not in (None, "IN"):
        raise ValueError(f"Unknown norm {norm!r}")


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with Flax's compute dtype: when ``compute_dtype`` is
    set, the input, weight and bias are cast to it (the cast of the
    parameters is differentiable, so their gradients stay float32), and
    the bias is added to the rounded convolution, as ``flax.linen.Conv``
    adds it (a fused bias would round once, not twice)."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        if self.bias is None:
            return y
        return y + self.bias.to(dt)[:, None, None]


class ConvTranspose2d(nn.ConvTranspose2d):
    """Flax's ``nn.ConvTranspose(kernel_size=(k, k), strides=(2, 2),
    padding="SAME")`` (``transpose_kernel=False``), which doubles ``H x
    W``.

    The weight is a torch ``ConvTranspose2d`` weight ``[in, out, k, k]``:
    the Flax kernel ``[k, k, in, out]`` flipped in space (Flax does not
    flip it, torch does) and permuted (``models/port.py``). lax's SAME
    rule pads the stride-dilated input by ``pad_a = ceil(k / 2)`` low
    (``k - 1`` for ``k < 3``) and ``k - pad_a`` high, which is torch's
    ``padding = k - 1 - pad_a`` and an output padding of ``k - 2 pad_a``:
    negative for an odd ``k >= 3``, so torch returns ``2H + 1`` rows and
    the last row and column are cropped. The compute dtype is
    :class:`Conv2d`'s."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3):
        pad_a = kernel_size - 1 if kernel_size < 3 else -(-kernel_size // 2)
        out_pad = kernel_size - 2 * pad_a
        super().__init__(in_channels, out_channels, kernel_size, stride=2,
                         padding=kernel_size - 1 - pad_a,
                         output_padding=max(out_pad, 0))

    def forward(self, x):
        h, w = x.shape[2:]
        dt = self.compute_dtype
        if dt is None:
            y = F.conv_transpose2d(x, self.weight, self.bias, self.stride,
                                   self.padding, self.output_padding)
        else:
            y = F.conv_transpose2d(x.to(dt), self.weight.to(dt), None,
                                   self.stride, self.padding,
                                   self.output_padding)
            y = y + self.bias.to(dt)[:, None, None]
        return y[:, :, :2 * h, :2 * w]


def set_compute_dtype(module: nn.Module, dtype) -> None:
    """Set the compute dtype (a ``torch.dtype``, a name such as
    ``"bfloat16"``, or ``None`` for none) of every :class:`Conv2d` and
    :class:`ConvTranspose2d` in ``module``."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    for m in module.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d)):
            m.compute_dtype = dtype


def instance_norm(norm: nn.GroupNorm, x):
    """Flax's ``GroupNorm(group_size=1)``: statistics in float32 (its
    ``force_float32_reductions``), the output in the promoted dtype of the
    input and the parameters (float32 after a bf16 conv, bf16 in a model
    cast to bf16 whole)."""
    out = F.group_norm(x.float(), norm.num_groups, norm.weight.float(),
                       norm.bias.float(), norm.eps)
    return out.to(torch.promote_types(x.dtype, norm.weight.dtype))


class ConvLayer(nn.Module):
    """Conv + optional instance norm + optional activation (reference
    ``submodules.py:8-62``). ``norm="IN"`` normalises each channel of each
    sample over its map, as the JAX package's ``nn.GroupNorm(group_size=
    1)`` (epsilon 1e-6, Flax's default) after the conv."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1,
                 activation: Optional[str] = "relu", norm=None,
                 w_scale: Optional[float] = None):
        super().__init__()
        _check_norm(norm)
        self.conv2d = Conv2d(in_channels, out_channels, kernel_size,
                             stride=stride, padding=kernel_size // 2)
        self.norm_layer = (nn.GroupNorm(out_channels, out_channels, eps=1e-6)
                           if norm == "IN" else None)
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
        if self.norm_layer is not None:
            x = instance_norm(self.norm_layer, x)
        return x if self.activation is None else self.activation(x)


class ConvGRU(nn.Module):
    """Convolutional GRU cell (reference ``submodules.py:111-152``)."""

    def __init__(self, input_size: int, hidden_size: int,
                 kernel_size: int = 3):
        super().__init__()
        pad = kernel_size // 2
        cin = input_size + hidden_size
        self.reset_gate = Conv2d(cin, hidden_size, kernel_size, padding=pad)
        self.update_gate = Conv2d(cin, hidden_size, kernel_size, padding=pad)
        self.out_gate = Conv2d(cin, hidden_size, kernel_size, padding=pad)

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
    """Two convs + identity shortcut (reference ``submodules.py:155-227``).
    As in the JAX package, ``norm="IN"`` adds no norm here (only BN would
    drop the biases there)."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 activation: Optional[str] = "relu", norm=None):
        super().__init__()
        _check_norm(norm)
        pad = kernel_size // 2
        self.conv1 = Conv2d(channels, channels, kernel_size, padding=pad)
        self.conv2 = Conv2d(channels, channels, kernel_size, padding=pad)
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
    """Bilinear x2 upsample (half-pixel centres, like ``jax.image.resize``;
    :func:`..ops.resize.upsample_bilinear`, whose backward is
    deterministic) + conv (reference ``submodules.py:230-273``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, activation: Optional[str] = "relu",
                 norm=None):
        super().__init__(in_channels, out_channels, kernel_size, stride=1,
                         activation=activation, norm=norm)

    def forward(self, x):
        return super().forward(upsample_bilinear(x, 2))


class TransposedConvLayer(nn.Module):
    """Transposed conv x2 upsample + optional activation, the decoder of
    ``use_upsample_conv: false``: the JAX package's ``TransposedConvLayer``
    (``taming_event_flow_tpu/models/blocks.py``), not the reference's
    ``ConvTranspose2d(padding=k // 2, output_padding=1)``, which pads
    otherwise (ROADMAP.md, section 3). As in the JAX layer, ``norm="IN"``
    adds no norm (only BN would drop the bias there)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, activation: Optional[str] = "relu",
                 norm=None):
        super().__init__()
        _check_norm(norm)
        self.transposed_conv2d = ConvTranspose2d(in_channels, out_channels,
                                                 kernel_size)
        self.activation = get_activation(activation)

    def init_weights(self, gen: torch.Generator):
        # Flax's defaults: lecun_normal (a normal truncated at two standard
        # deviations, rescaled to variance 1 / fan_in) with fan_in = k * k
        # * in, and a zero bias
        w = self.transposed_conv2d.weight
        std = math.sqrt(1.0 / w[:, 0].numel()) / 0.87962566103423978
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)
        nn.init.zeros_(self.transposed_conv2d.bias)

    def forward(self, x):
        x = self.transposed_conv2d(x)
        return x if self.activation is None else self.activation(x)


def init_weights(module: nn.Module, gen: torch.Generator) -> None:
    """Initialise every block of ``module`` from ``gen`` (module order)."""
    for m in module.modules():
        if hasattr(m, "init_weights") and m is not module:
            m.init_weights(gen)

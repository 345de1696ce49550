"""The model registry: the PyTorch counterpart of
``taming_event_flow_tpu/models/model.py`` (RecEVFlowNet, EVFlowNet and, from
:mod:`.fire`, the FireFlowNet family, built by name in :func:`build_model`).

Public tensors keep the JAX package's layout: the input is NHWC
``[B, H, W, C]`` and the flows come back ``[S, B, H, W, 2]`` in (x, y)
order, finest scale last. The networks run NCHW inside, and a recurrent
carry is a tuple of NCHW maps (``()`` for a stateless model).

``compute_dtype`` (e.g. ``"bfloat16"``) is Flax's: the parameters stay
float32 and every convolution computes in that dtype
(:func:`.blocks.set_compute_dtype`); the flows come back float32, and a
recurrent carry stays float32, as in the JAX package.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import upsample_bilinear
from ..utils.device import resolve_device
from .blocks import init_weights, set_compute_dtype
from .fire import FireFlowNet, RecFireFlowNet
from .unet import MultiResUNet, MultiResUNetRecurrent


def pad_to_multiple(x, min_size: int = 16):
    """Top-left zero-pad NHWC input to a multiple of ``min_size``
    (reference ``models/model_util.py:52-65``)."""
    h, w = x.shape[1], x.shape[2]
    ph = (min_size - h % min_size) % min_size
    pw = (min_size - w % min_size) % min_size
    if ph or pw:
        x = F.pad(x, (0, 0, pw, 0, ph, 0))
    return x, (ph, pw)


def unpad(x, pads: Tuple[int, int]):
    """Inverse of :func:`pad_to_multiple` for NHWC tensors."""
    ph, pw = pads
    return x[:, ph:, pw:, :]


def _upsampled(preds, num_encoders: int, padded: Tuple[int, int], pads):
    """Each scale's prediction upsampled to the padded input size
    (``jax.image.resize(method="bilinear")``'s half-pixel centres, by the
    integer factor between the two sizes; :func:`..ops.resize.
    upsample_bilinear`, whose backward is deterministic), scaled by ``2 **
    (num_encoders - i - 1)`` and unpadded: ``[S, B, H, W, 2]``."""
    flows = []
    for i, flow in enumerate(preds):
        scale = 2 ** (num_encoders - i - 1)
        size = tuple(flow.shape[2:])
        if size != tuple(padded):
            factor = padded[0] // size[0]
            if tuple(padded) != (factor * size[0], factor * size[1]):
                raise ValueError(f"the padded size {tuple(padded)} is not an "
                                 f"integer multiple of the prediction's "
                                 f"{size}")
            flow = upsample_bilinear(flow, factor)
        flows.append(unpad((scale * flow).permute(0, 2, 3, 1), pads))
    return torch.stack(flows, dim=0)


class RecEVFlowNet(nn.Module):
    """Recurrent EV-FlowNet (reference ``models/model.py:6-85``).

    ``forward(x, state) -> (flows, new_state)``; flow values are in the final
    activation's range, callers apply ``flow_scaling``.
    """

    arch_cls = MultiResUNetRecurrent

    def __init__(self, num_bins: int = 2, base_channels: int = 64,
                 num_encoders: int = 4, num_residual_blocks: int = 2,
                 num_output_channels: int = 2, skip_type: str = "sum",
                 norm=None, use_upsample_conv: bool = True,
                 kernel_size: int = 3, channel_multiplier: float = 2,
                 final_activation: Optional[str] = "tanh",
                 final_w_scale: Optional[float] = None, min_size: int = 16,
                 compute_dtype: Optional[str] = None):
        super().__init__()
        self.num_encoders = num_encoders
        self.min_size = min_size
        self.arch = self.arch_cls(
            num_bins=num_bins, base_channels=base_channels,
            num_encoders=num_encoders,
            num_residual_blocks=num_residual_blocks,
            num_output_channels=num_output_channels, skip_type=skip_type,
            norm=norm, use_upsample_conv=use_upsample_conv,
            kernel_size=kernel_size, channel_multiplier=channel_multiplier,
            final_activation=final_activation, final_w_scale=final_w_scale,
        )
        set_compute_dtype(self, compute_dtype)

    def forward(self, x, state):
        x, pads = pad_to_multiple(x, self.min_size)
        preds, new_state = self.arch(
            x.permute(0, 3, 1, 2).contiguous(), state)
        return _upsampled(preds, self.num_encoders, x.shape[1:3],
                          pads), new_state

    def init_state(self, batch: int, height: int, width: int,
                   dtype=torch.float32, device=None):
        """Zero recurrent carry (= reference ``reset_states``)."""
        ph = (self.min_size - height % self.min_size) % self.min_size
        pw = (self.min_size - width % self.min_size) % self.min_size
        return self.arch.init_state(batch, height + ph, width + pw, dtype,
                                    device)


class EVFlowNet(RecEVFlowNet):
    """Stateless EV-FlowNet (``taming_event_flow_tpu/models/model.py:
    EVFlowNet``): the same padding, decoder and upsampling around
    :class:`~.unet.MultiResUNet`. Its carry is ``()``."""

    arch_cls = MultiResUNet

    def forward(self, x, state=()):
        x, pads = pad_to_multiple(x, self.min_size)
        preds = self.arch(x.permute(0, 3, 1, 2).contiguous())
        return _upsampled(preds, self.num_encoders, x.shape[1:3], pads), ()

    def init_state(self, batch: int, height: int, width: int,
                   dtype=torch.float32, device=None):
        return ()


_MODEL_REGISTRY = {
    "RecEVFlowNet": RecEVFlowNet,
    "EVFlowNet": EVFlowNet,
    "RecFireFlowNet": RecFireFlowNet,
    "FireFlowNet": FireFlowNet,
}


def build_model(model_config: Dict[str, Any], num_bins: int = 2,
                device="cuda", seed: int = 0) -> nn.Module:
    """Build the model ``model_config["name"]`` names (default
    ``RecEVFlowNet``) from a config dict, with weights drawn from ``seed``,
    on ``device`` (the card unless the caller asks for the CPU). As in the
    JAX package, the config keys a model does not take are ignored.

    :raises ValueError: for a name outside the registry.
    """
    dev = resolve_device(device)
    name = model_config.get("name", "RecEVFlowNet")
    if name not in _MODEL_REGISTRY:
        raise ValueError(f"Unknown model: {name!r}")
    cls = _MODEL_REGISTRY[name]
    takes = inspect.signature(cls.__init__).parameters
    kwargs = {k: v for k, v in model_config.items() if k in takes
              and k != "num_bins"}
    model = cls(num_bins=num_bins, **kwargs)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev)

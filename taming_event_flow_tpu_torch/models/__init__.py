from .fire import FireFlowNet, RecFireFlowNet
from .model import EVFlowNet, RecEVFlowNet, build_model, pad_to_multiple, unpad
from .port import (
    flax_params_to_state_dict,
    optax_state_to_torch,
    state_dict_to_flax_params,
)
from .unet import MultiResUNet, MultiResUNetRecurrent

__all__ = [
    "RecEVFlowNet",
    "EVFlowNet",
    "RecFireFlowNet",
    "FireFlowNet",
    "build_model",
    "pad_to_multiple",
    "unpad",
    "flax_params_to_state_dict",
    "state_dict_to_flax_params",
    "optax_state_to_torch",
    "MultiResUNet",
    "MultiResUNetRecurrent",
]

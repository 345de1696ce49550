from .model import RecEVFlowNet, build_model, pad_to_multiple, unpad
from .port import flax_params_to_state_dict
from .unet import MultiResUNetRecurrent

__all__ = [
    "RecEVFlowNet",
    "build_model",
    "pad_to_multiple",
    "unpad",
    "flax_params_to_state_dict",
    "MultiResUNetRecurrent",
]

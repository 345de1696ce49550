from .fire import FireFlowNet, RecFireFlowNet
from .model import EVFlowNet, RecEVFlowNet, build_model, pad_to_multiple, unpad
from .port import flax_params_to_state_dict
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
    "MultiResUNet",
    "MultiResUNetRecurrent",
]

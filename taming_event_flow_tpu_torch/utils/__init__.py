from .device import resolve_device
from .diagnostics import SectionTimer, annotate, profile_trace, save_diff
from .progress import ProgressBar, StepMeter
from .visualization import (
    Visualization,
    decode_dsec_flow,
    encode_dsec_flow,
    error_to_image,
    events_to_image,
    flow_to_image,
    flow_to_u16,
    u16_to_flow,
)

__all__ = ["resolve_device", "SectionTimer", "annotate", "profile_trace",
           "save_diff", "ProgressBar",
           "StepMeter", "Visualization", "decode_dsec_flow",
           "encode_dsec_flow", "error_to_image", "events_to_image",
           "flow_to_image", "flow_to_u16", "u16_to_flow"]

from .device import resolve_device
from .diagnostics import SectionTimer, save_diff
from .progress import ProgressBar, StepMeter
from .visualization import flow_to_u16, u16_to_flow

__all__ = ["resolve_device", "SectionTimer", "save_diff", "ProgressBar",
           "StepMeter", "flow_to_u16", "u16_to_flow"]

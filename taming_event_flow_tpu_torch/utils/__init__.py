from .device import resolve_device
from .diagnostics import SectionTimer
from .visualization import flow_to_u16, u16_to_flow

__all__ = ["resolve_device", "SectionTimer", "flow_to_u16", "u16_to_flow"]

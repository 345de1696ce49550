from .base import (
    events_to_channels_np,
    rectify_events,
    remap,
    remap_index,
)

__all__ = ["events_to_channels_np", "rectify_events", "remap", "remap_index"]

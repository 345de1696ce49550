from .cuda_warp import (
    LAUNCHES,
    gather_bilinear,
    gather_bilinear_plain,
    reset_launches,
    splat_bilinear,
    splat_bilinear_plain,
)
from .encodings import derive_count_input, events_to_channels, events_to_image
from .precision import set_tf32
from .warp import (
    event_propagation,
    gather_values,
    get_event_flow,
    inside_mask,
    iwe_from_events,
    purge_unfeasible,
    splat_values,
)

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "splat_bilinear",
    "splat_bilinear_plain",
    "gather_bilinear",
    "gather_bilinear_plain",
    "derive_count_input",
    "events_to_image",
    "events_to_channels",
    "set_tf32",
    "event_propagation",
    "inside_mask",
    "purge_unfeasible",
    "gather_values",
    "get_event_flow",
    "splat_values",
    "iwe_from_events",
]

from .base import (
    LossConfig,
    flow_spatial_smoothing,
    flow_temporal_smoothing,
    focus_loss,
    global_ts,
    iwe_with_ts,
)
from .iterative import iterative_loss, warp_table_triangular
from .linear import linear_loss

LOSS_REGISTRY = {
    "Iterative": iterative_loss,
    "Linear": linear_loss,
}

__all__ = [
    "LossConfig",
    "global_ts",
    "iwe_with_ts",
    "focus_loss",
    "flow_spatial_smoothing",
    "flow_temporal_smoothing",
    "iterative_loss",
    "warp_table_triangular",
    "linear_loss",
    "LOSS_REGISTRY",
]

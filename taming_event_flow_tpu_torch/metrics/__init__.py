from .validation import (
    METRIC_REGISTRY,
    IterativeValidation,
    LinearValidation,
    ValConfig,
    ValState,
    compute_aee,
    compute_fwl,
    compute_rsat,
    compute_rsat_fwl,
    forward_prop_flow_once,
    grow_val_state,
)

__all__ = [
    "METRIC_REGISTRY",
    "IterativeValidation",
    "LinearValidation",
    "ValConfig",
    "ValState",
    "compute_aee",
    "compute_fwl",
    "compute_rsat",
    "compute_rsat_fwl",
    "forward_prop_flow_once",
    "grow_val_state",
]

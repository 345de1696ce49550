from .checkpoint import (
    save_checkpoint,
    load_checkpoint,
    load_reference_torch_checkpoint,
)
from .store import (
    TrackingStore,
    set_tracking_uri,
    set_experiment,
    start_run,
    active_run,
    end_run,
    log_params,
    log_metric,
    log_artifact,
    get_run,
    default_store,
)
from .tensorboard import TensorBoardMirror

__all__ = [
    "TrackingStore",
    "set_tracking_uri",
    "set_experiment",
    "start_run",
    "active_run",
    "end_run",
    "log_params",
    "log_metric",
    "log_artifact",
    "get_run",
    "default_store",
    "save_checkpoint",
    "load_checkpoint",
    "load_reference_torch_checkpoint",
    "TensorBoardMirror",
]

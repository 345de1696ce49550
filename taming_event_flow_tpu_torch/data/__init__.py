from .base import (
    BaseStreamLoader,
    bucket_size,
    events_to_channels_np,
    events_to_image_np,
    events_to_voxel_np,
    pad_events,
    rectify_events,
    remap,
    remap_index,
)
from .cache import CacheDataset
from .h5 import FlowMapsIndex, H5Loader, bisect_getter
from .prefetch import Prefetcher
from .synthetic import SyntheticSequence, synthetic_sequence, write_synthetic_h5

__all__ = [
    "BaseStreamLoader",
    "CacheDataset",
    "FlowMapsIndex",
    "H5Loader",
    "Prefetcher",
    "SyntheticSequence",
    "bisect_getter",
    "bucket_size",
    "events_to_channels_np",
    "events_to_image_np",
    "events_to_voxel_np",
    "pad_events",
    "rectify_events",
    "remap",
    "remap_index",
    "synthetic_sequence",
    "write_synthetic_h5",
]

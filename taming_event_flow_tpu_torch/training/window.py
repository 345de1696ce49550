"""Host-side window assembly (the port's own copy of ``pad_batch_events``
from ``taming_event_flow_tpu/training/window.py``)."""

from __future__ import annotations

from typing import Dict

import numpy as np


def pad_batch_events(batch: Dict[str, np.ndarray], n: int):
    """Re-pad one batch's ragged event tensors to length ``n`` (>= current);
    padding rows are zero, so they carry zero polarity masks."""
    out = dict(batch)
    for key in ["event_list", "event_list_pol_mask", "grad_mask",
                "event_raw_xy"]:
        if key in out:
            arr = out[key]
            if arr.shape[1] < n:
                padded = np.zeros(
                    (arr.shape[0], n) + arr.shape[2:], arr.dtype
                )
                padded[:, : arr.shape[1]] = arr
                out[key] = padded
    return out

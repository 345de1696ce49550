"""The DSEC 16-bit flow codec (counterpart of ``flow_to_u16``/
``u16_to_flow`` in ``taming_event_flow_tpu/utils/visualization.py``)."""

from __future__ import annotations

import numpy as np
import torch


def flow_to_u16(flow):
    """Quantize a flow map to the DSEC 16-bit PNG lattice on the device:
    ``uint16(flow * 128 + 2**15)``, clamped to the lattice. Halves the
    bytes of the ``flow_bw`` readback; the PNG store re-encodes
    :func:`u16_to_flow`'s output to these exact values."""
    return torch.clamp(flow * 128.0 + 2.0**15, 0.0, 65535.0).to(torch.uint16)


def u16_to_flow(enc: np.ndarray) -> np.ndarray:
    """Host-side inverse of :func:`flow_to_u16` (exact on the lattice)."""
    return (enc.astype(np.float32) - 2.0**15) / 128.0

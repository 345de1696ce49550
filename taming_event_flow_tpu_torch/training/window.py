"""Host-side window assembly: the port's own copy of
``taming_event_flow_tpu/training/window.py`` (``stack_window``,
``pad_batch_events`` and ``WindowGrouper``)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def stack_window(batches: List[Dict[str, np.ndarray]],
                 packed: bool = False) -> Dict[str, np.ndarray]:
    """Stack P collated batches into ``[P, B, ...]`` arrays for the train
    step (``training.step.make_train_step``), re-padding ragged event
    tensors to the window's longest bucket.

    The plain wire only: the count input ships as the loader built it (the
    host-remapped one for a rectified lane). ``packed=True``, the JAX
    package's packed wire, raises.
    """
    if packed:
        raise NotImplementedError(
            "the packed window wire is not ported yet; see ROADMAP.md "
            "(packed wire formats, item 6)")
    n = max(b["event_list"].shape[1] for b in batches)

    def pad(arr):
        k = arr.shape[1]
        if k == n:
            return arr
        padded = np.zeros((arr.shape[0], n) + arr.shape[2:], arr.dtype)
        padded[:, :k] = arr
        return padded

    return {
        "net_input": np.stack([b["net_input"] for b in batches]),
        "event_list": np.stack([pad(b["event_list"]) for b in batches]),
        "pol_mask": np.stack([pad(b["event_list_pol_mask"]) for b in batches]),
        "grad_mask": np.stack([pad(b["grad_mask"]) for b in batches]),
    }


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


class WindowGrouper:
    """Mirror of the eval consumer's window-grouping state machine.

    A prefetch producer stages a GT window's inputs exactly when the
    consumer's buffer will reach ``passes`` cleanly, which requires
    replaying the consumer's transitions on the producer side:

      * ``new_seq``: partial window dropped, counters reset;
      * ``ts_jump``: buffered passes flushed per pass (the recovery then
        runs per pass until the boundary), so the mirror's pass counter
        accumulates across a jump;
      * a clean P-th batch completes a window (the staging point), after
        which the consumer's boundary block resets its counter.

    ``feed`` returns the buffered batch list exactly when a full clean
    window formed, else ``None``.
    """

    def __init__(self, passes: int):
        self.passes = passes
        self.buf: List = []
        self.pd = 0  # mirror of the consumer's passes_done

    def feed(self, batch, new_seq: bool, ts_jump: bool):
        if new_seq:
            self.buf.clear()
            self.pd = 0
        if ts_jump:
            self.pd += len(self.buf)
            self.buf.clear()
        out = None
        if self.pd == 0:
            self.buf.append(batch)
            if len(self.buf) == self.passes:
                out = list(self.buf)
                self.buf.clear()
                self.pd = self.passes
        else:
            self.pd += 1
        if self.pd == self.passes:
            self.pd = 0
        return out

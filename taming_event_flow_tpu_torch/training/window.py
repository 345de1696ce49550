"""Host-side window assembly: the port's own copy of
``taming_event_flow_tpu/training/window.py`` (``stack_window`` with both
wires, ``pack_net_input``, ``pad_batch_events`` and ``WindowGrouper``)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def pack_net_input(net: np.ndarray) -> np.ndarray:
    """Narrow an integer-valued (count) net input to the smallest dtype
    that holds it exactly: uint8 for the usual per-pixel counts, uint16 for
    the heavy tail; past 65535 it stays float32. The step casts it back to
    float32, exact for integers in range."""
    m = net.max()
    if m < 256:
        return net.astype(np.uint8)
    if m < np.iinfo(np.uint16).max + 1:
        return net.astype(np.uint16)
    return net


def stack_window(batches: List[Dict[str, np.ndarray]], packed: bool = False,
                 net_compact: bool = False,
                 derive_net: bool = False) -> Dict[str, np.ndarray]:
    """Stack P collated batches into ``[P, B, ...]`` arrays for the train
    step (``training.step.make_train_step``), re-padding ragged event
    tensors to the window's longest bucket.

    The plain wire ships the loader's arrays as they are. ``packed=True``
    is the JAX package's packed wire, exact by construction
    (``training.step.unpack_window`` restores the plain window on the
    device):

      * ``event_txy`` ``[P, B, N, 3]`` float32 and ``event_p`` ``[P, B, N]``
        int8 replace ``event_list`` (polarity is +-1 or 0);
      * ``pol_mask`` is not shipped: it is ``[p > 0, p < 0]``, the
        loader's own construction;
      * ``grad_mask`` ships as bool (its values are 0 and 1);
      * with ``net_compact`` (count inputs, integer by construction) the
        net input ships as uint8/uint16 when it fits
        (:func:`pack_net_input`); voxel inputs are fractional, so leave it
        off for them;
      * with ``derive_net`` (count inputs, no rectified lane: a rectified
        lane's remap can change mid-window at a rollover) the net input is
        not shipped at all, and the step rebuilds it from the event lists
        (``ops.encodings.derive_count_input``).
    """
    n = max(b["event_list"].shape[1] for b in batches)

    def pad(arr):
        k = arr.shape[1]
        if k == n:
            return arr
        padded = np.zeros((arr.shape[0], n) + arr.shape[2:], arr.dtype)
        padded[:, :k] = arr
        return padded

    if not packed:
        return {
            "net_input": np.stack([b["net_input"] for b in batches]),
            "event_list": np.stack([pad(b["event_list"]) for b in batches]),
            "pol_mask": np.stack([pad(b["event_list_pol_mask"])
                                  for b in batches]),
            "grad_mask": np.stack([pad(b["grad_mask"]) for b in batches]),
        }

    p_ct, b_ct = len(batches), batches[0]["event_list"].shape[0]
    txy = np.zeros((p_ct, b_ct, n, 3), np.float32)
    pol = np.zeros((p_ct, b_ct, n), np.int8)
    grad = np.zeros((p_ct, b_ct, n, 1), bool)
    for i, b in enumerate(batches):
        ev = b["event_list"]
        k = ev.shape[1]
        txy[i, :, :k] = ev[..., :3]
        pol[i, :, :k] = ev[..., 3]
        grad[i, :, :k] = b["grad_mask"] != 0
    out = {"event_txy": txy, "event_p": pol, "grad_mask": grad}
    if not derive_net:
        net = np.stack([b["net_input"] for b in batches])
        out["net_input"] = pack_net_input(net) if net_compact else net
    return out


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

"""The host staging of the eval pipeline's windowed path: a ring of host
buffers that a GT window's arrays are stacked and packed into, in place,
and uploaded from without blocking the host (:class:`StagingRing`)."""

from __future__ import annotations

import numpy as np
import torch

from ..utils.diagnostics import count


class StagingRing:
    """Slots of host buffers, one buffer a name in each slot. A GT window
    takes the next slot (:meth:`next_slot`), fills its buffers through the
    numpy views :meth:`buffer` hands out, and has each copied to a fresh
    device tensor (:meth:`upload`) by one :meth:`flush` once it is packed.

    On a card the buffers are page-locked and a copy does not block the
    host: a CUDA event recorded after a slot's last copy guards the slot,
    and :meth:`next_slot` waits on it before the slot is filled again, so
    the host stages the next window while the device runs the last. On the
    CPU the buffers are plain and an upload is a copy, in the same
    rotation. A buffer is allocated when its name first asks for a shape
    and dtype, and again only when they change (a grown bucket).

    While a profile is active it counts ``h2d_bytes`` and
    ``h2d_async_bytes`` (each upload's bytes), and ``stage_slot_waits``
    (+1 where a slot's last copies were still pending when it was taken).
    """

    def __init__(self, device: torch.device, n_slots: int = 2):
        self.device = device
        self.cuda = device.type == "cuda"
        self.slots = [{} for _ in range(n_slots)]
        self.done = [None] * n_slots  # a CUDA event after a slot's copies
        self.k = 0  # the slot being filled
        self.filled = set()  # names filled since the slot was taken
        self.pending = []  # (device tensor, host buffer) to copy

    def next_slot(self) -> None:
        """Take the next slot, once its last uploads have landed."""
        self.flush()
        self.k = (self.k + 1) % len(self.slots)
        self.filled = set()
        ev = self.done[self.k]
        if ev is not None and not ev.query():
            count("stage_slot_waits", 1)
            ev.synchronize()

    def buffer(self, name: str, shape, dtype) -> np.ndarray:
        """The host buffer ``name`` of the current slot, ``shape`` and
        (numpy) ``dtype``, to fill in place. A name filled twice takes the
        next slot first, so a copy in flight is never overwritten."""
        if name in self.filled:
            self.next_slot()
        self.filled.add(name)
        slot = self.slots[self.k]
        host = slot.get(name)
        dtype = torch.from_numpy(np.empty(0, dtype)).dtype
        if host is None or host.shape != tuple(shape) or host.dtype != dtype:
            host = slot[name] = torch.empty(tuple(shape), dtype=dtype,
                                            pin_memory=self.cuda)
        return host.numpy()

    def upload(self, name: str) -> torch.Tensor:
        """A fresh device tensor that the current slot's buffer ``name`` is
        copied into by the next :meth:`flush`."""
        host = self.slots[self.k][name]
        nbytes = host.numel() * host.element_size()
        count("h2d_bytes", nbytes)
        count("h2d_async_bytes", nbytes)
        dev = torch.empty_like(host, device=self.device)
        self.pending.append((dev, host))
        return dev

    def flush(self) -> None:
        """Issue the pending copies in the order of their uploads (on a
        card without blocking, in stream order, and the event that guards
        the slot after them). A window's copies go out together once it is
        packed: a copy into a stream that another thread's blocking
        readback holds waits for that readback, and then no packing waits
        behind it."""
        for dev, host in self.pending:
            dev.copy_(host, non_blocking=self.cuda)
        if self.cuda and self.pending:
            if self.done[self.k] is None:
                self.done[self.k] = torch.cuda.Event()
            self.done[self.k].record(torch.cuda.current_stream(self.device))
        self.pending = []

"""Background window production: the port's own copy of
``taming_event_flow_tpu/data/prefetch.py``.

One producer thread owns the stateful stream (the loader) and runs ahead of
the device through a bounded queue; the consumer sees the stream's items in
order. numpy and h5py release the GIL in their heavy parts, so production
overlaps the consumer's wait on the card.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator


class Prefetcher:
    """Run ``iterable`` in a daemon thread, ``depth`` items ahead.

    Exceptions raised by the producer re-raise in the consumer at the point
    of ``next()``. Iteration order is preserved exactly.
    """

    _END = object()

    def __init__(self, iterable: Iterable, depth: int = 3):
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._iterable = iterable
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._iterable:
                self._queue.put(item)
                if self._closed:
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised consumer-side
            self._queue.put(e)
        # always end the stream, so a consumer that keeps iterating after an
        # error never blocks on a dead producer
        self._queue.put(self._END)

    def close(self):
        """Release the producer thread (it may be blocked on the bounded
        queue). Safe to call more than once."""
        self._closed = True
        while self._thread.is_alive():
            try:
                self._queue.get_nowait()
            except queue.Empty:
                self._thread.join(timeout=0.05)

    def __iter__(self) -> Iterator:
        while True:
            item = self._queue.get()
            if item is self._END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

"""TensorBoard mirror for training scalars: the port's own copy of
``taming_event_flow_tpu/tracking/tensorboard.py``.

Events go under ``<run>/artifacts/tensorboard/``, so each run's TB data
travels with its tracked artifacts. Without an importable writer the mirror
does nothing and training proceeds unaffected.
"""

from __future__ import annotations

from typing import Optional

from .store import default_store


def _writer_cls():
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter
    except Exception:
        try:
            from tensorboardX import SummaryWriter

            return SummaryWriter
        except Exception:
            return None


class TensorBoardMirror:
    """Scalar mirror bound to a tracked run (no-op without tensorboard)."""

    def __init__(self, run_id: str, logdir: Optional[str] = None):
        cls = _writer_cls()
        if logdir is None:
            logdir = default_store().artifact_dir(run_id, "tensorboard")
        self._writer = cls(log_dir=logdir) if cls is not None else None

    @property
    def enabled(self) -> bool:
        return self._writer is not None

    def add_scalar(self, tag: str, value: float, step: int):
        if self._writer is not None:
            self._writer.add_scalar(tag, value, step)

    def replay(self, run_id: str, key: str = "loss", tag: str = "loss"):
        """Replay a prior run's metric history (warm-start continuity,
        reference ``utils/utils.py:33-44``)."""
        if self._writer is None:
            return 0
        n = 0
        for _, value, step in default_store().read_metric(run_id, key):
            self._writer.add_scalar(tag, value, step)
            n += 1
        return n

    def flush(self):
        if self._writer is not None:
            self._writer.flush()

    def close(self):
        if self._writer is not None:
            self._writer.close()
            self._writer = None

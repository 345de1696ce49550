"""Device resolution for the port's entry points."""

from __future__ import annotations

import os

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU. A bare ``"cuda"`` is this rank's card, ``cuda:<LOCAL_RANK>``
    under ``torchrun``. Raises when a CUDA device is asked for and none is
    found, or the one asked for does not exist — the port never falls back
    to the CPU on its own."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    if dev.index is None and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if dev.index is not None and dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"{dev} does not exist: this machine has "
                           f"{torch.cuda.device_count()} CUDA devices")
    return dev

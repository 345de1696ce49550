"""The yardstick's arithmetic: the card's peaks and the model's operations,
computed from the configuration's shapes (never read from the program).

:data:`CARD_PEAKS` is a copy of ``bench_torch.CARD_PEAKS`` (NVIDIA's H100
SXM5 datasheet, dense rates without sparsity, at the 700 W limit), keyed by
``torch.cuda.get_device_name()``; a card missing from it raises.
"""

from __future__ import annotations

import subprocess
from typing import Dict

from reference.models import lookup

CARD_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"float32": 66.9e12, "tf32": 494.7e12,
                              "bfloat16": 989.4e12, "hbm_bytes_s": 3.35e12},
}


def card_peaks(name: str) -> Dict[str, float]:
    if name not in CARD_PEAKS:
        raise KeyError(f"no peaks known for {name!r}: add the card's "
                       f"datasheet rates to CARD_PEAKS")
    return CARD_PEAKS[name]


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def pass_flops(model_cfg: Dict, height: int, width: int, batch: int,
               train: bool) -> int:
    """Operations of one pass of the configuration's model (its module's
    ``conv_layers``), as ``torch.utils.flop_counter`` counts a
    convolution (2 x batch x c_out x c_in x k x k x h_out x w_out; biases,
    activations and resizing not counted): the forward, and with ``train``
    its backward, the input gradient of every convolution but the first
    and the weight gradient of each."""
    total = 0
    layers = lookup(model_cfg).conv_layers(model_cfg, height, width)
    for cin, cout, k, h, w, first in layers:
        f = 2 * batch * cout * cin * k * k * h * w
        total += f
        if train:
            total += f if first else 2 * f
    return total

"""Seeded weights, made on the device in one draw: the benchmark's own
initialiser, at the shapes and init scales that the configuration's model
module gives (``reference/models/<name>.py``: ``weight_shapes``,
``init_bounds``). Both the program (through its ``load_state_dict``) and
the plain reference get these tensors.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from reference.models import lookup


def make_weights(model_cfg: Dict, seed: int, device) -> Dict[str,
                                                            torch.Tensor]:
    """Every parameter from ``seed``: one uniform draw in [-1, 1) on
    ``device`` with a ``torch.Generator`` there, each tensor scaled by its
    layer's bound (a bound of 0: zeros). The same seed gives the same
    weights."""
    mod = lookup(model_cfg)
    shapes = mod.weight_shapes(model_cfg)
    bounds = {}
    for name, shape in shapes.items():
        b = mod.init_bounds(name, shape, model_cfg)
        if b is not None:
            bounds[name.rsplit(".", 1)[0]] = b
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & (2 ** 63 - 1))
    flat = torch.empty(total, device=device).uniform_(-1.0, 1.0,
                                                      generator=gen)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        t = flat[off: off + n].view(shape)
        off += n
        wb, bb = bounds[name.rsplit(".", 1)[0]]
        scale = wb if name.endswith(".weight") else bb
        out[name] = t * scale if scale else torch.zeros_like(t)
    return out

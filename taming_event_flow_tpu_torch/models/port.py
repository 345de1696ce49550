"""JAX (Flax) parameters -> the port's ``state_dict``, for the four model
families of the registry.

For RecEVFlowNet this is the inverse of ``taming_event_flow_tpu/models/
port.py:torch_state_dict_to_flax``: the port's modules carry the reference
torch names, so the Flax tree maps back name for name; EVFlowNet and the
Fire models follow the same rule. Conv kernels go from Flax ``[kh, kw, in,
out]`` to torch ``[out, in, kh, kw]``::

  arch/encoder_<i>/conv/Conv_0            -> arch.encoders.<i>.conv.conv2d
  arch/encoder_<i>/recurrent_block/<gate> -> arch.encoders.<i>.recurrent_block.<gate>
  arch/encoder_<i>/Conv_0 (EVFlowNet)     -> arch.encoders.<i>.conv2d
  arch/resblock_<j>/conv<k>               -> arch.resblocks.<j>.conv<k>
  arch/decoder_<i>/conv/Conv_0            -> arch.decoders.<i>.conv2d
  arch/pred_<i>/Conv_0                    -> arch.preds.<i>.conv2d
  <head|conv1|conv2|conv3|pred>/Conv_0    -> <name>.conv2d        (Fire)
  <gru1|gru2>/<gate>                      -> <name>.<gate>         (Fire)

With ``norm: IN`` each conv layer's ``GroupNorm_0`` (beside its ``Conv_0``)
maps to the layer's ``norm_layer``, its ``scale`` to ``weight``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

# a conv layer's two Flax children and their torch names
_LAYER = r"(Conv_0|GroupNorm_0)"
_CHILD = {"Conv_0": "conv2d", "GroupNorm_0": "norm_layer"}

_PATTERNS = [
    (re.compile(rf"^arch/encoder_(\d+)/conv/{_LAYER}$"),
     r"arch.encoders.\1.conv.\2"),
    (re.compile(r"^arch/encoder_(\d+)/recurrent_block/"
                r"(reset_gate|update_gate|out_gate)$"),
     r"arch.encoders.\1.recurrent_block.\2"),
    (re.compile(rf"^arch/encoder_(\d+)/{_LAYER}$"), r"arch.encoders.\1.\2"),
    (re.compile(r"^arch/resblock_(\d+)/(conv1|conv2)$"),
     r"arch.resblocks.\1.\2"),
    (re.compile(rf"^arch/decoder_(\d+)/conv/{_LAYER}$"),
     r"arch.decoders.\1.\2"),
    (re.compile(rf"^arch/pred_(\d+)/{_LAYER}$"), r"arch.preds.\1.\2"),
    (re.compile(r"^(head|conv1|conv2|conv3|pred)/(Conv_0)$"), r"\1.\2"),
    (re.compile(r"^(gru1|gru2)/(reset_gate|update_gate|out_gate)$"),
     r"\1.\2"),
]


def _leaves(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix, k, v


def flax_params_to_state_dict(params_np: Mapping) -> Dict[str, torch.Tensor]:
    """Convert the Flax ``params`` tree (numpy leaves) of a registry model
    (RecEVFlowNet, EVFlowNet, RecFireFlowNet, FireFlowNet) into a
    ``state_dict`` for the port's model of the same name.

    :raises KeyError: on a parameter path the port has no module for.
    """
    out = {}
    for path, leaf, value in _leaves(params_np):
        module = "/".join(path)
        for pat, repl in _PATTERNS:
            if pat.match(module):
                name = re.sub(_LAYER + "$", lambda c: _CHILD[c.group(1)],
                              pat.sub(repl, module))
                break
        else:
            raise KeyError(f"No port module for Flax parameter {module}")
        value = np.asarray(value, dtype=np.float32)
        if leaf == "kernel":
            out[f"{name}.weight"] = torch.from_numpy(
                np.ascontiguousarray(np.transpose(value, (3, 2, 0, 1))))
        elif leaf == "bias":
            out[f"{name}.bias"] = torch.from_numpy(value.copy())
        elif leaf == "scale" and name.endswith(".norm_layer"):
            out[f"{name}.weight"] = torch.from_numpy(value.copy())
        else:
            raise KeyError(f"Unexpected Flax leaf {module}/{leaf}")
    return out

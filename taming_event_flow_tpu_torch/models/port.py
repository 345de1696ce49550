"""JAX (Flax) parameters <-> the port's ``state_dict``, for the four model
families of the registry, and an optax Adam state into a torch optimizer.

The port's modules carry the reference torch names, so the Flax tree maps
name for name (``taming_event_flow_tpu/models/port.py:
torch_state_dict_to_flax`` is the JAX side of RecEVFlowNet's). Conv kernels
are Flax ``[kh, kw, in, out]`` and torch ``[out, in, kh, kw]``::

  arch/encoder_<i>/conv/Conv_0            <-> arch.encoders.<i>.conv.conv2d
  arch/encoder_<i>/recurrent_block/<gate> <-> arch.encoders.<i>.recurrent_block.<gate>
  arch/encoder_<i>/Conv_0 (EVFlowNet)     <-> arch.encoders.<i>.conv2d
  arch/resblock_<j>/conv<k>               <-> arch.resblocks.<j>.conv<k>
  arch/decoder_<i>/conv/Conv_0            <-> arch.decoders.<i>.conv2d
  arch/decoder_<i>/ConvTranspose_0        <-> arch.decoders.<i>.transposed_conv2d
  arch/pred_<i>/Conv_0                    <-> arch.preds.<i>.conv2d
  <head|conv1|conv2|conv3|pred>/Conv_0    <-> <name>.conv2d        (Fire)
  <gru1|gru2>/<gate>                      <-> <name>.<gate>         (Fire)

With ``norm: IN`` each conv layer's ``GroupNorm_0`` (beside its ``Conv_0``)
is the layer's ``norm_layer``, its ``scale`` the ``weight``. A
``ConvTranspose_0`` kernel (``use_upsample_conv: false``) becomes a torch
``ConvTranspose2d`` weight ``[in, out, kh, kw]``, flipped in space, since
Flax's transposed conv does not flip its kernel and torch's does
(``models/blocks.py: ConvTranspose2d``).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

# (Flax module path, torch module name); a placeholder stands for the same
# part on both sides, ``{layer}`` for a conv layer's child
_MODULES = [
    ("arch/encoder_{i}/conv/{layer}", "arch.encoders.{i}.conv.{layer}"),
    ("arch/encoder_{i}/recurrent_block/{gate}",
     "arch.encoders.{i}.recurrent_block.{gate}"),
    ("arch/encoder_{i}/{layer}", "arch.encoders.{i}.{layer}"),
    ("arch/resblock_{i}/{conv}", "arch.resblocks.{i}.{conv}"),
    ("arch/decoder_{i}/conv/{layer}", "arch.decoders.{i}.{layer}"),
    ("arch/decoder_{i}/ConvTranspose_0",
     "arch.decoders.{i}.transposed_conv2d"),
    ("arch/pred_{i}/{layer}", "arch.preds.{i}.{layer}"),
    ("{fire}/Conv_0", "{fire}.conv2d"),
    ("{gru}/{gate}", "{gru}.{gate}"),
]
_PARTS = {"i": r"\d+", "gate": "reset_gate|update_gate|out_gate",
          "conv": "conv1|conv2", "fire": "head|conv1|conv2|conv3|pred",
          "gru": "gru1|gru2"}
# a conv layer's two Flax children and their torch names
_LAYER = {"Conv_0": "conv2d", "GroupNorm_0": "norm_layer"}
_LAYER_BACK = {v: k for k, v in _LAYER.items()}


def _rules(side: int, layers: Mapping):
    """``(regex, target template)`` per row of ``_MODULES``, matching the
    names of ``side`` (0: Flax, 1: torch)."""
    out = []
    for row in _MODULES:
        parts = re.split(r"\{(\w+)\}", row[side])
        regex = "".join(
            re.escape(p) if k % 2 == 0 else
            f"(?P<{p}>{'|'.join(layers) if p == 'layer' else _PARTS[p]})"
            for k, p in enumerate(parts))
        out.append((re.compile(f"^{regex}$"), row[1 - side]))
    return out


_TO_TORCH = _rules(0, _LAYER)
_TO_FLAX = _rules(1, _LAYER_BACK)


def _rename(name: str, rules, layers: Mapping, missing: str) -> str:
    for pat, target in rules:
        m = pat.match(name)
        if m:
            parts = m.groupdict()
            if "layer" in parts:
                parts["layer"] = layers[parts["layer"]]
            return target.format(**parts)
    raise KeyError(f"{missing} {name}")


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
        name = _rename(module, _TO_TORCH, _LAYER,
                       "No port module for Flax parameter")
        value = np.asarray(value, dtype=np.float32)
        if leaf == "kernel" and name.endswith(".transposed_conv2d"):
            out[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(
                np.transpose(value[::-1, ::-1], (2, 3, 0, 1))))
        elif leaf == "kernel":
            out[f"{name}.weight"] = torch.from_numpy(
                np.ascontiguousarray(np.transpose(value, (3, 2, 0, 1))))
        elif leaf == "bias":
            out[f"{name}.bias"] = torch.from_numpy(value.copy())
        elif leaf == "scale" and name.endswith(".norm_layer"):
            out[f"{name}.weight"] = torch.from_numpy(value.copy())
        else:
            raise KeyError(f"Unexpected Flax leaf {module}/{leaf}")
    return out


def state_dict_to_flax_params(state_dict: Mapping) -> Dict:
    """The inverse of :func:`flax_params_to_state_dict`: a registry model's
    ``state_dict`` (tensors on any device, or numpy arrays) as the Flax
    ``params`` tree of numpy float32 arrays, conv kernels in Flax's
    ``[kh, kw, in, out]`` (a transposed conv's flipped back).

    :raises KeyError: on a parameter the Flax models have no leaf for.
    """
    params: Dict = {}
    for full, value in state_dict.items():
        name, leaf = full.rsplit(".", 1)
        path = _rename(name, _TO_FLAX, _LAYER_BACK,
                       "No Flax module for torch parameter").split("/")
        if torch.is_tensor(value):
            value = value.detach().cpu().numpy()
        value = np.asarray(value, dtype=np.float32)
        if leaf == "bias":
            flax_leaf = "bias"
        elif leaf == "weight" and name.endswith(".norm_layer"):
            flax_leaf = "scale"
        elif leaf == "weight" and name.endswith(".transposed_conv2d"):
            flax_leaf = "kernel"
            value = np.transpose(value, (2, 3, 0, 1))[::-1, ::-1]
        elif leaf == "weight" and value.ndim == 4:
            flax_leaf = "kernel"
            value = np.transpose(value, (2, 3, 1, 0))
        else:
            raise KeyError(f"Unexpected torch parameter {full}")
        node = params
        for p in path:
            node = node.setdefault(p, {})
        node[flax_leaf] = np.ascontiguousarray(value)
    return params


def _adam_nodes(tree):
    """The maps of ``tree`` whose keys are exactly optax Adam's state,
    ``{count, mu, nu}`` (``ScaleByAdamState`` under flax's state dict)."""
    if isinstance(tree, Mapping):
        if set(tree) == {"count", "mu", "nu"}:
            yield tree
            return
        for v in tree.values():
            yield from _adam_nodes(v)


def _has_arrays(tree) -> bool:
    if isinstance(tree, Mapping):
        return any(_has_arrays(v) for v in tree.values())
    return isinstance(tree, np.ndarray)


def optax_state_to_torch(opt_state_tree, model: torch.nn.Module,
                         optimizer: torch.optim.Optimizer) -> None:
    """Load an optax state tree, as flax's state dict holds it (tuples as
    maps keyed ``"0"``, ``"1"``, ...), into ``optimizer``, which
    ``training.build_optimizer`` built over ``model.parameters()``.

    Adam and AdamW: the ``{count, mu, nu}`` node, wherever the chain holds
    it (clipped or not), becomes each parameter's ``exp_avg`` (``mu``),
    ``exp_avg_sq`` (``nu``), bit for bit, and ``step`` (``count`` as torch
    Adam's float32 scalar, exact below 2**24). SGD keeps no state, and an
    SGD tree leaves it untouched.

    :raises ValueError: where the tree and the optimizer disagree: an Adam
        tree into SGD, a tree without an Adam node into Adam, a parameter
        missing from or extra to the model, a shape that differs.
    """
    kind = type(optimizer).__name__
    nodes = list(_adam_nodes(opt_state_tree))
    if not isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)):
        if nodes or _has_arrays(opt_state_tree):
            raise ValueError(f"an optax state with moments cannot load into "
                             f"{kind}, which keeps none")
        return
    if len(nodes) != 1:
        raise ValueError(f"{kind} needs one Adam state (count, mu, nu) in "
                         f"the optax tree; found {len(nodes)}")
    node = nodes[0]
    params = dict(model.named_parameters())
    owned = {id(p) for g in optimizer.param_groups for p in g["params"]}
    if owned != {id(p) for p in params.values()}:
        raise ValueError(f"the {kind} optimizer was not built over this "
                         "model's parameters")
    moments = {}
    for key in ("mu", "nu"):
        tensors = flax_params_to_state_dict(node[key])
        missing = sorted(set(params) - set(tensors))
        extra = sorted(set(tensors) - set(params))
        if missing or extra:
            raise ValueError(f"Adam {key}: missing {missing}, extra {extra}")
        moments[key] = tensors
    count = np.asarray(node["count"])
    if count.shape != () or count.dtype.kind not in "iu":
        raise ValueError(f"Adam count {count!r} is no integer scalar")
    for name, p in params.items():
        mu, nu = moments["mu"][name], moments["nu"][name]
        if mu.shape != p.shape or nu.shape != p.shape:
            raise ValueError(f"Adam moments of {name}: {tuple(mu.shape)}, "
                             f"{tuple(nu.shape)}; parameter "
                             f"{tuple(p.shape)}")
        optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": mu.to(device=p.device, dtype=p.dtype),
            "exp_avg_sq": nu.to(device=p.device, dtype=p.dtype),
        }

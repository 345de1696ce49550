"""Checkpoint save and restore addressed by tracking run id (counterpart of
``taming_event_flow_tpu/tracking/checkpoint.py``).

A checkpoint is one ``torch.save`` file, ``artifacts/model/checkpoint.pt``,
holding the model's ``state_dict``, the optimizer's ``state_dict`` (the
Adam moments and step count, which the reference loses on resume), ``step``
and ``epoch``. The JAX package writes flax msgpack (``checkpoint.msgpack``:
its ``params``, optax ``opt_state``, ``step`` and ``epoch``), and
:func:`load_checkpoint` reads that too (:mod:`.flax_msgpack`), so a run of
either package warm-starts and evaluates in the port.

The port's parameter names are the reference's, so a reference
``model.pth`` loads as it is (:func:`load_reference_torch_checkpoint`).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch

from ..models.port import flax_params_to_state_dict
from . import flax_msgpack
from .store import default_store

CKPT_NAME = "checkpoint.pt"
JAX_CKPT_NAME = "checkpoint.msgpack"


def save_checkpoint(run_id: str, model_state: Dict[str, torch.Tensor],
                    optim_state: Optional[Dict[str, Any]] = None,
                    step: int = 0, epoch: int = 0, store=None) -> str:
    """Write ``(model_state, optim_state, step, epoch)`` under the run's
    ``artifacts/model/`` (atomically: a temporary file, then a rename)."""
    store = store or default_store()
    path = os.path.join(store.artifact_dir(run_id, "model"), CKPT_NAME)
    tmp = path + ".tmp"
    torch.save({"model": model_state, "optimizer": optim_state,
                "step": int(step), "epoch": int(epoch)}, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(run_id: str, store=None, map_location="cpu"
                    ) -> Tuple[Optional[Dict[str, Any]], int]:
    """Read a run's checkpoint onto ``map_location``: its ``checkpoint.pt``,
    else the JAX package's ``checkpoint.msgpack`` in the same shape, with
    ``model`` the params through ``models.flax_params_to_state_dict``,
    ``optimizer`` ``None`` and ``optax_state`` the raw optax state tree
    (``None`` where the run saved none; ``models.optax_state_to_torch``
    loads it into an optimizer).

    :return: ``(checkpoint | None, starting_epoch)``: ``None`` and 0 for an
        unknown run or a run without a checkpoint, as the reference's
        ``load_model`` warm-starts only when it can
        (``utils/utils.py:9-49``).
    """
    store = store or default_store()
    try:
        run = store.get_run(run_id)
    except (KeyError, TypeError):
        return None, 0
    model_dir = os.path.join(run.info.artifact_uri, "model")
    path = os.path.join(model_dir, CKPT_NAME)
    jax_path = os.path.join(model_dir, JAX_CKPT_NAME)
    if os.path.isfile(path):
        ckpt = torch.load(path, map_location=map_location, weights_only=True)
    elif os.path.isfile(jax_path):
        with open(jax_path, "rb") as f:
            tree = flax_msgpack.loads(f.read())
        model = flax_params_to_state_dict(tree["params"])
        ckpt = {"model": {k: v.to(map_location) for k, v in model.items()},
                "optimizer": None, "optax_state": tree["opt_state"],
                "step": int(tree["step"]), "epoch": int(tree["epoch"])}
    else:
        print(f"No model found at {run_id}")
        return None, 0
    print(f"Model restored from {run_id}")
    return ckpt, int(ckpt.get("epoch", 0))


def load_reference_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``model.pth`` (a pickled torch module or a
    ``state_dict``) as a ``state_dict`` for the port's
    :class:`~..models.RecEVFlowNet`, whose names are the reference's.

    A pickled module is unpickled in full (and its package must be
    importable): load only files you trust.

    :raises ValueError: for a reference transposed-conv decoder
        (``transposed_conv2d``): the reference pads it otherwise than the
        JAX package and the port (ROADMAP.md, section 3), so its weights
        would load into a layer of other semantics."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    state_dict = obj if isinstance(obj, dict) else obj.state_dict()
    refused = sorted(k for k in state_dict if ".transposed_conv2d." in k)
    if refused:
        raise ValueError(
            f"{refused[0]}: the reference's transposed-conv decoder pads "
            "otherwise than the port's (ROADMAP.md, section 3); its "
            "weights do not load")
    return {k: v.detach().cpu() for k, v in state_dict.items()}

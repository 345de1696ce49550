"""The reference's models, one module a model family, found by the
configuration's ``model.name``: ``reference/models/<name, lower case>.py``.

Each module gives what the benchmark needs of its family, so that a new
family is a new file here and nothing else changes:

* ``FIXED``: the model options it implements, each with the one value it
  implements; ``NUMBERS``: the keys of the sizes and scales it reads;
* ``weight_shapes(cfg)``: name -> shape of every parameter, in the port's
  ``state_dict`` naming, and ``init_bounds(name, shape, cfg)``: the
  ``(weight, bias)`` bounds of that parameter's layer (weights are drawn
  uniform in them, :mod:`harness.weights`);
* ``conv_layers(cfg, h, w)``: every convolution of one pass, for the
  operation count (:mod:`harness.work`);
* ``init_state(cfg, batch, h, w, dtype, device)`` and ``forward(params,
  cfg, x, state, dtype, quant, finest_only)``.
"""

from __future__ import annotations

import importlib
from typing import Dict

_UNSET = object()


def lookup(model_cfg: Dict):
    """The module of ``model_cfg["name"]``, after checking that it
    implements every option the configuration states: a key it does not
    know, or an option with another value than the one it implements (or
    none stated), raises."""
    name = model_cfg["name"]
    try:
        mod = importlib.import_module(f"{__name__}.{name.lower()}")
    except ModuleNotFoundError as e:
        raise NotImplementedError(
            f"the reference has no model {name!r}: add "
            f"benchmark/reference/models/{name.lower()}.py") from e
    for key, want in mod.FIXED.items():
        got = model_cfg.get(key, _UNSET)
        if got is _UNSET or got != want:
            raise NotImplementedError(
                f"the reference's {name} implements {key} = {want!r} only; "
                f"the configuration states "
                f"{'nothing' if got is _UNSET else repr(got)}")
    unknown = set(model_cfg) - set(mod.FIXED) - set(mod.NUMBERS) - {"name"}
    if unknown:
        raise NotImplementedError(
            f"the reference's {name} does not implement "
            f"{sorted(unknown)}")
    return mod

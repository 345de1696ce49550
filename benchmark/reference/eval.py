"""The reference replay of an eval sequence: the count input (with the
rectification's backward index), the rectified event coordinates, the model
at the protocol's precision with its carry, the Iterative validation, and
each GT window's FWL, RSAT, AEE and u16 ``flow_bw``.

Frozen copy of what ``taming_event_flow_tpu_torch/pipeline/eval.py``
(``EvalPipeline`` on the u32 wire: ``window_metrics``, the windowed and the
per-pass paths), ``ops/encodings.py`` (``derive_count_input`` with
``remap_idx``, ``unpack_event_wire``'s lookup) and ``training/step.py``
(``make_eval_step``, ``make_eval_window_step``) compute, at commit 96ab861.
Departures: the inputs come from the benchmark's raw events (integer
coordinates, polarity, timestamps) and its rectification tables, not from
the program's wire, so the wire and its lookup are checked by the result;
the rectified coordinates are read from the forward map with numpy-style
indexing (the same float32 values the wire's row gather copies).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from . import no_tf32
from .models import lookup
from .validation import Window, compute_aee, flow_to_u16


def count_input(raw, res, remap_idx=None):
    """``raw [n, 4]`` (ts, y, x, p) integer coordinates -> ``[H, W, 2]``
    per-polarity counts, remapped through the 1-based backward index when
    given (0 or out of range: no source, zero counts)."""
    h, w = res
    y = raw[:, 1].long().clamp(0, h - 1)
    x = raw[:, 2].long().clamp(0, w - 1)
    p = raw[:, 3]
    img = torch.zeros(h * w, 2, device=raw.device)
    img.index_put_((y * w + x, (p < 0).long()), p.abs(), accumulate=True)
    if remap_idx is not None:
        src = remap_idx.reshape(-1).long()
        ok = (src > 0) & (src <= h * w)
        img = torch.where(ok[:, None], img[(src - 1).clamp(0, h * w - 1)],
                          torch.zeros_like(img[:1]))
    return img.reshape(h, w, 2)


def replay(seq, weights: Dict[str, torch.Tensor], model_cfg: Dict,
           mix: Dict, flow_scaling: float, device,
           quant: Optional[Callable] = None) -> List[Dict]:
    """Every GT window of the sequence ``seq`` (``harness.events.
    EvalSequence``) from a zero carry: ``[{"fwl", "rsat", "aee",
    "flow_bw"}]`` on the host (``flow_bw`` int32, or ``None`` where the
    protocol reads none back)."""
    no_tf32()
    ref_model = lookup(model_cfg)
    proto = mix["pipeline"]
    mets = proto["metrics"]
    res = tuple(mix["resolution"])
    passes = mix["passes"]
    dtype = (torch.bfloat16 if mets.get("inference_dtype") in
             ("bfloat16", "bf16") else None)
    vis = proto.get("vis") or {}
    want_bw = bool(vis.get("enabled") or vis.get("store")) and (
        vis.get("show") is None or "flow_bw" in vis["show"])
    ridx = rect = None
    if seq.rect is not None:
        ridx = torch.as_tensor(seq.rect.remap_idx, device=device)
        rect = torch.as_tensor(seq.rect.rect_map, device=device)
    carry = ref_model.init_state(model_cfg, 1, res[0], res[1],
                                 dtype=dtype or torch.float32, device=device)
    out = []
    with torch.no_grad():
        for wi in range(len(seq.gt)):
            win = Window(res, device)
            for pi in range(passes):
                raw = torch.as_tensor(seq.raw[wi * passes + pi],
                                      device=device)
                ev = raw.clone()
                if rect is not None:
                    yi, xi = raw[:, 1].long(), raw[:, 2].long()
                    ev[:, 1] = rect[yi, xi, 1]
                    ev[:, 2] = rect[yi, xi, 0]
                x = count_input(raw, res, ridx)[None]
                emask = (x.sum(-1, keepdim=True) > 0).float()
                pol = torch.stack([ev[:, 3] > 0, ev[:, 3] < 0], -1).float()
                flows, carry = ref_model.forward(weights, model_cfg, x, carry,
                                                 dtype=dtype, quant=quant,
                                                 finest_only=True)
                flow = flows[-1].float() * flow_scaling
                win.update(flow, ev[None], pol[None], emask)
            rsat, fwl = win.rsat_fwl()
            flow_bw = win.backward_flow() * passes
            gt = torch.as_tensor(seq.gt[wi], device=device)[None]
            mask = win.event_image() if mets.get("mask_aee") else None
            aee = compute_aee(flow_bw, gt, event_mask=mask,
                              res_aee=mets.get("res_aee"),
                              vertical_crop_aee=mets.get("vertical_crop_aee"))
            out.append({"fwl": float(fwl), "rsat": float(rsat),
                        "aee": float(aee),
                        "flow_bw": (flow_to_u16(flow_bw).cpu().numpy()
                                    if want_bw else None)})
    return out

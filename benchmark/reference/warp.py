"""Plain bilinear gather and splat, differentiable by autograd.

Frozen copy of the arithmetic of ``taming_event_flow_tpu_torch/ops/
cuda_warp.py`` (``_taps``, ``splat_bilinear_plain``,
``gather_bilinear_plain``) and ``ops/warp.py`` (``get_event_flow``,
``purge_unfeasible``, ``inside_mask``, ``splat_values``) at commit 96ab861.

Departures: the gradient is autograd's of the 4-tap formula, where the port
has hand-written backward passes (fused gather, splat of the cotangent)
that follow JAX's rule at an integer coordinate (``dtri`` = (-0.5, -1,
+0.5)); the two agree wherever a differentiated location is not an integer.
The benchmark's training traffic keeps timestamps inside (0, 1), so a
warped location lands on an integer only by chance. The splat sums in
float32 with ``index_add``, the port's kernel in fixed point.
"""

from __future__ import annotations

import torch


def _taps(loc, h: int, w: int):
    y, x = loc[..., 0], loc[..., 1]
    y0, x0 = torch.floor(y).detach(), torch.floor(x).detach()
    fy, fx = y - y0, x - x0
    taps = []
    for dy in (0, 1):
        ty = y0 + dy
        wy = fy if dy else 1.0 - fy
        in_y = (ty >= 0) & (ty <= h - 1)
        for dx in (0, 1):
            tx = x0 + dx
            wx = fx if dx else 1.0 - fx
            ok = in_y & (tx >= 0) & (tx <= w - 1)
            weight = torch.where(ok, wy * wx, torch.zeros_like(wy))
            idx = (torch.where(ok, ty, torch.zeros_like(ty)).long() * w
                   + torch.where(ok, tx, torch.zeros_like(tx)).long())
            taps.append((idx, weight))
    return taps


def splat(loc, values, res):
    """``out[b, h, w, c] = sum_e tri(y_e - h) tri(x_e - w) values[b, e,
    c]``: ``loc [B, M, 2]`` (y, x), ``values [B, M, C]`` -> ``[B, H, W,
    C]``."""
    b, m, c = values.shape
    h, w = res
    out = torch.zeros(b * h * w, c, dtype=torch.float32, device=values.device)
    base = (torch.arange(b, device=values.device) * (h * w))[:, None]
    for idx, weight in _taps(loc, h, w):
        out = out.index_add(0, (idx + base).reshape(-1),
                            (values * weight[..., None]).reshape(-1, c))
    return out.reshape(b, h, w, c)


def gather(maps, loc):
    """``maps [B, H, W, C]`` sampled bilinearly at ``loc [B, M, 2]`` (y, x);
    taps outside the frame read zero."""
    b, h, w, c = maps.shape
    flat = maps.reshape(b, h * w, c)
    out = None
    for idx, weight in _taps(loc, h, w):
        got = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        term = got * weight[..., None]
        out = term if out is None else out + term
    return out


def event_flow(flow_map, loc):
    """Flow map ``[B, H, W, 2]`` (x, y) at ``loc`` -> ``[B, N, 2]`` (y,
    x)."""
    return gather(flow_map.float(), loc.float()).flip(-1)


def inside_mask(loc, res):
    inside = ((loc[..., 0:1] >= 0) & (loc[..., 0:1] <= res[0] - 1.0)
              & (loc[..., 1:2] >= 0) & (loc[..., 1:2] <= res[1] - 1.0))
    return inside.to(loc.dtype)


def purge(loc, mask, res):
    inside = inside_mask(loc, res)
    return loc * inside, mask * inside


def splat_rounded(loc, values, res):
    """The splat at ``round(loc)`` (half to even), no gradient through the
    rounding."""
    return splat(torch.round(loc).detach(), values, res)

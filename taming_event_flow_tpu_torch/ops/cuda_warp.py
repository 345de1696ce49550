"""Bilinear splat and gather: hand-written CUDA kernels on the card, their
plain PyTorch versions on the CPU.

Counterpart of the Pallas kernels in ``taming_event_flow_tpu/ops/
pallas_warp.py`` (``_splat_kernel`` and ``_gather_kernel``, forward only);
the kernels live in ``csrc/warp_kernels.cu`` (see its header for the design
and what bounds it on an H100).

The wrappers dispatch on the device of the tensors they are given: a CPU
tensor goes to the plain version in this module, a CUDA tensor to the
kernel. There is no fallback: a CUDA tensor whose kernel fails to build or
launch raises. Each wrapper adds one to :data:`LAUNCHES` where it launches
its kernel, so a run can show that it went through the kernels.

Both functions evaluate the 4-tap stencil ``tri(y - h) * tri(x - w)`` at
the taps ``{floor(y), floor(y)+1} x {floor(x), floor(x)+1}``; taps outside
``[0, H-1] x [0, W-1]`` are dropped.
"""

from __future__ import annotations

from typing import Tuple

import torch

LAUNCHES = {"splat_bilinear": 0, "gather_bilinear": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ------------------------------------------------------------ plain versions


def _taps(loc, h: int, w: int):
    """The four bilinear taps of each ``(y, x)`` in ``loc [B, M, 2]``, in
    the kernels' order (00, 01, 10, 11): ``(flat index [B, M] int64,
    weight [B, M])`` pairs, out-of-frame taps at index 0 with weight 0."""
    y, x = loc[..., 0], loc[..., 1]
    y0, x0 = torch.floor(y), torch.floor(x)
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
            weight = torch.where(ok, wy * wx, 0.0)
            idx = (torch.where(ok, ty, 0.0).long() * w
                   + torch.where(ok, tx, 0.0).long())
            taps.append((idx, weight))
    return taps


def splat_bilinear_plain(loc, values, res: Tuple[int, int]):
    """``out[b, h, w, c] = sum_e tri(y_e - h) tri(x_e - w) values[b, e, c]``.

    :param loc: ``[B, M, 2]`` float32 ``(y, x)``.
    :param values: ``[B, M, C]`` float32.
    :return: ``[B, H, W, C]`` float32.
    """
    b, m, c = values.shape
    h, w = res
    out = torch.zeros(b * h * w, c, dtype=torch.float32, device=values.device)
    base = (torch.arange(b, device=values.device) * (h * w))[:, None]
    for idx, weight in _taps(loc, h, w):
        out.index_add_(0, (idx + base).reshape(-1),
                       (values * weight[..., None]).reshape(-1, c))
    return out.reshape(b, h, w, c)


def gather_bilinear_plain(maps, loc):
    """``out[b, e, c] = sum_hw tri(y_e - h) tri(x_e - w) maps[b, h, w, c]``
    (``grid_sample(bilinear, align_corners=True, zeros)`` at pixel
    coordinates), summed in tap order like the kernel.

    :param maps: ``[B, H, W, C]`` float32.
    :param loc: ``[B, M, 2]`` float32 ``(y, x)``.
    :return: ``[B, M, C]`` float32.
    """
    b, h, w, c = maps.shape
    flat = maps.reshape(b, h * w, c)
    out = None
    for idx, weight in _taps(loc, h, w):
        got = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        term = got * weight[..., None]
        out = term if out is None else out + term
    return out


# ----------------------------------------------------------------- wrappers


def _check(name, t, ndim, last=None):
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != ndim or (last is not None and t.shape[-1] != last):
        raise ValueError(f"{name} has shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(fn_name, counter, args):
    from . import kernel_build

    lib = kernel_build.load().lib
    rc = getattr(lib, fn_name)(*args)
    if rc != 0:
        raise RuntimeError(
            f"{fn_name} launch failed: {lib.tef_error_string(rc).decode()}")
    LAUNCHES[counter] += 1


def _on_card(*tensors) -> bool:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("all inputs must be on one device")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return True


def splat_bilinear(loc, values, res: Tuple[int, int]):
    """Bilinear splat (see :func:`splat_bilinear_plain`): the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors. ``C <= 4`` on the
    card."""
    _check("loc", loc, 3, 2)
    _check("values", values, 3)
    b, m, c = values.shape
    if loc.shape[:2] != (b, m):
        raise ValueError("loc and values disagree on [B, M]")
    if not _on_card(loc, values):
        return splat_bilinear_plain(loc, values, res)
    h, w = res
    if not 1 <= c <= 4:
        raise ValueError(f"the splat kernel takes 1..4 channels, got {c}")
    out = torch.zeros(b, h, w, c, dtype=torch.float32, device=values.device)
    if b * m == 0:
        return out
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch("tef_splat_bilinear", "splat_bilinear",
                (loc.data_ptr(), values.data_ptr(), out.data_ptr(),
                 b, m, c, h, w, stream))
    return out


def gather_bilinear(maps, loc):
    """Bilinear gather (see :func:`gather_bilinear_plain`): the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors. ``C <= 4`` on the
    card."""
    _check("maps", maps, 4)
    _check("loc", loc, 3, 2)
    b, h, w, c = maps.shape
    m = loc.shape[1]
    if loc.shape[0] != b:
        raise ValueError("maps and loc disagree on B")
    if not _on_card(maps, loc):
        return gather_bilinear_plain(maps, loc)
    if not 1 <= c <= 4:
        raise ValueError(f"the gather kernel takes 1..4 channels, got {c}")
    out = torch.empty(b, m, c, dtype=torch.float32, device=maps.device)
    if b * m == 0:
        return out
    with torch.cuda.device(maps.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch("tef_gather_bilinear", "gather_bilinear",
                (maps.data_ptr(), loc.data_ptr(), out.data_ptr(),
                 b, m, c, h, w, stream))
    return out

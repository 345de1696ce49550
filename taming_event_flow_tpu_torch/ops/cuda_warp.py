"""Bilinear splat and gather, and the row gather: hand-written CUDA kernels
on the card, their plain PyTorch versions on the CPU, and the autograd
Functions around the bilinear pair.

Counterpart of the Pallas kernels in ``taming_event_flow_tpu/ops/
pallas_warp.py`` (``_splat_kernel``, ``_gather_kernel`` and
``_gather_fused_kernel``), of its custom VJPs (``_splat_vjp``,
``_gather_vjp``) and of the row fetch ``dma_gather``
(``scripts/bench_dma_gather.py``); the kernels live in
``csrc/warp_kernels.cu`` (see its header for the design and what bounds
each on an H100).

The wrappers dispatch on the device of the tensors they are given: a CPU
tensor goes to the plain version in this module, a CUDA tensor to the
kernel. There is no fallback: a CUDA tensor whose kernel fails to build or
launch raises. Each wrapper adds one to :data:`LAUNCHES` where it launches
its kernel, so a run can show that it went through the kernels.

Splat and gather evaluate the 4-tap stencil ``tri(y - h) * tri(x - w)`` at
the taps ``{floor(y), floor(y)+1} x {floor(x), floor(x)+1}``; taps outside
``[0, H-1] x [0, W-1]`` are dropped. The fused gather adds the derivative
stencil ``dtri`` of the Pallas kernels (:func:`gather_fused_dloc_plain`)
and writes the location gradient as one ``[B, M, 2]`` array.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

LAUNCHES = {"splat_bilinear": 0, "gather_bilinear": 0, "gather_fused": 0,
            "row_gather": 0}


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


def _dual_axis(coord, size: int):
    """One axis of the dual stencil over the taps ``floor(c) - 1 + k``,
    ``k = 0, 1, 2``: ``(tap [B, M] int64, tri, dtri, in_frame)`` per tap,
    the weights zero outside ``[0, size - 1]``. ``dtri`` is jax's autodiff
    rule for ``max(0, 1 - |d|)`` (the Pallas ``_stencil``): ``(0, -1, +1)``
    at a fractional coordinate, ``(-0.5, -1, +0.5)`` at an integer one."""
    c0 = torch.floor(coord)
    f = coord - c0
    integer = f == 0
    tri = (torch.zeros_like(f), 1.0 - f, f)
    dtri = (torch.where(integer, -0.5, 0.0), torch.full_like(f, -1.0),
            torch.where(integer, 0.5, 1.0))
    taps = []
    for k in range(3):
        t = c0 + (k - 1)
        ok = (t >= 0) & (t <= size - 1)
        taps.append((torch.where(ok, t, 0.0).long(),
                     torch.where(ok, tri[k], 0.0),
                     torch.where(ok, dtri[k], 0.0), ok))
    return taps


def gather_fused_dloc_plain(maps, loc, values, with_gv: bool = True):
    """The gather and both location derivatives in one pass, contracted
    with ``values`` over channels::

        gv[b, e, c]    = sum tri(y - h) tri(x - w) maps[b, h, w, c]
        d_loc[b, e, 0] = sum_c values[b, e, c] sum dtri(y-h) tri(x-w) maps
        d_loc[b, e, 1] = sum_c values[b, e, c] sum tri(y-h) dtri(x-w) maps

    summed in the kernel's order (y tap, x tap, channel).

    :param maps: ``[B, H, W, C]`` float32.
    :param loc: ``[B, M, 2]`` float32 ``(y, x)``.
    :param values: ``[B, M, C]`` float32.
    :return: ``(gv [B, M, C] or None when not with_gv, d_loc [B, M, 2]``
        ``(dy, dx))``.
    """
    b, h, w, c = maps.shape
    flat = maps.reshape(b, h * w, c)
    ys, xs = _dual_axis(loc[..., 0], h), _dual_axis(loc[..., 1], w)
    zero = torch.zeros(b, loc.shape[1], c, dtype=torch.float32,
                       device=maps.device)
    gv = sy = sx = zero
    for ty, wy, dwy, oky in ys:
        a = bx = zero
        for tx, wx, dwx, okx in xs:
            idx = (ty * w + tx)[..., None].expand(-1, -1, c)
            m = torch.where((oky & okx)[..., None],
                            torch.gather(flat, 1, idx), 0.0)
            a = a + wx[..., None] * m
            bx = bx + dwx[..., None] * m
        gv = gv + wy[..., None] * a
        sy = sy + dwy[..., None] * a
        sx = sx + wy[..., None] * bx
    dy = dx = zero[..., 0]
    for ch in range(c):
        dy = dy + values[..., ch] * sy[..., ch]
        dx = dx + values[..., ch] * sx[..., ch]
    return (gv if with_gv else None), torch.stack([dy, dx], dim=-1)


def gather_fused_plain(maps, loc, values, with_gv: bool = True):
    """:func:`gather_fused_dloc_plain` as ``(gv, dy [B, M], dx [B, M])``,
    ``dy`` and ``dx`` the columns of its ``d_loc``."""
    gv, d_loc = gather_fused_dloc_plain(maps, loc, values, with_gv)
    return gv, d_loc[..., 0], d_loc[..., 1]


def row_gather_plain(table, idx):
    """``out[m, :] = table[clamp(idx[m], 0, R - 1), :]``: an index outside
    the table is clamped to its first or last row, as the kernel does.

    :param table: ``[R, W]`` float32.
    :param idx: ``[M]`` int32.
    :return: ``[M, W]`` float32.
    """
    return table[idx.long().clamp(0, table.shape[0] - 1)]


# ----------------------------------------------------------------- wrappers


def _check(name, t, ndim, last=None):
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != ndim or (last is not None and t.shape[-1] != last):
        raise ValueError(f"{name} has shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# the kernel library (ctypes; its C functions resolved and declared when it
# loads), kept at first CUDA launch so that later launches skip the build
# module's lock
_lib = None

# the current stream's handle of a device index: the private getter that
# PyTorch's own generated kernels call (checked with torch 2.11 for CUDA
# 12.8), since torch.cuda.current_stream(index) builds a Stream object on
# every call; a build without it (CPU-only, or a release that renames it)
# gets the public call
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
    lambda index: torch.cuda.current_stream(index).cuda_stream)


def _library():
    global _lib
    if _lib is None:
        from . import kernel_build

        _lib = kernel_build.load().lib
    return _lib


def _launch(kernel, counter, dev, *args):
    """Call ``kernel`` (a C entry point of the library) with ``args`` and
    the current stream of ``dev``, entering ``dev`` only when it is not the
    current device; raise with CUDA's message if the launch failed."""
    stream = _raw_stream(dev.index)
    if dev.index == torch.cuda.current_device():
        rc = kernel(*args, stream)
    else:
        with torch.cuda.device(dev):
            rc = kernel(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{kernel.__name__} launch failed: "
                           f"{_library().tef_error_string(rc).decode()}")
    LAUNCHES[counter] += 1


def _on_card(*tensors) -> bool:
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError("all inputs must be on one device")
    if dev.type == "cuda":
        return True
    if dev.type != "cpu":
        raise ValueError(f"no kernel for device {dev}")
    return False


def _channels(kernel, c):
    if not 1 <= c <= 4:
        raise ValueError(f"the {kernel} kernel takes 1..4 channels, got {c}")


def splat_scale_exponent(values):
    """Per batch lane of ``values [B, M, C]``, the exponent ``k`` the splat
    kernel scales the lane's products by before it sums them as int64:
    ``k = 62 - ceil(log2(4 n)) - e``, ``n`` the lane's rows with a finite
    non-zero value (at least 1) and ``max |v| = f * 2^e``, ``f`` in ``[0.5,
    1)``, over its finite values (``e = 0`` for none). The kernel computes
    it on the card; this is for checks of its error bound, a pixel of ``m``
    non-zero products within ``m * 2^(-k-1)`` of their exact sum before the
    one rounding to float. Returns a list of ``B`` ints."""
    mag = values.detach().abs()
    mag = torch.where(torch.isfinite(mag), mag, 0.0).reshape(
        values.shape[0], values.shape[1], -1)
    top = mag.amax(dim=(1, 2)).tolist() if mag.numel() else [0.0] * len(mag)
    rows = (mag != 0).any(-1).sum(-1).tolist()
    return [62 - (4 * max(n, 1) - 1).bit_length() - math.frexp(t)[1]
            for t, n in zip(top, rows)]


def splat_bilinear(loc, values, res: Tuple[int, int]):
    """Bilinear splat (see :func:`splat_bilinear_plain`): the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors. ``C <= 4`` on the
    card, where the sum is taken in fixed point (``csrc/warp_kernels.cu``),
    so that a call repeats bit for bit."""
    _check("loc", loc, 3, 2)
    _check("values", values, 3)
    b, m, c = values.shape
    if loc.shape[:2] != (b, m):
        raise ValueError("loc and values disagree on [B, M]")
    if not _on_card(loc, values):
        return splat_bilinear_plain(loc, values, res)
    h, w = res
    _channels("splat", c)
    out = torch.empty(b, h, w, c, dtype=torch.float32, device=values.device)
    if b * m == 0:
        return out.zero_()
    # the int64 sums [B, H, W, C], a flag word a pixel and two words a lane
    # (max |v|, non-zero rows), which the entry point zeroes before the
    # kernels add into them
    pixels = b * h * w
    scratch = torch.empty(pixels * c + (pixels + 1) // 2 + b,
                          dtype=torch.int64, device=values.device)
    _launch(_library().tef_splat_bilinear, "splat_bilinear", values.device,
            loc.data_ptr(), values.data_ptr(), out.data_ptr(), b, m, c, h, w,
            scratch.data_ptr())
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
    _channels("gather", c)
    out = torch.empty(b, m, c, dtype=torch.float32, device=maps.device)
    if b * m == 0:
        return out
    _launch(_library().tef_gather_bilinear, "gather_bilinear", maps.device,
            maps.data_ptr(), loc.data_ptr(), out.data_ptr(), b, m, c, h, w)
    return out


def gather_fused_dloc(maps, loc, values, with_gv: bool = True):
    """Fused dual-stencil gather (see :func:`gather_fused_dloc_plain`): the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    ``C <= 4`` on the card; ``with_gv=False`` skips the gather values.
    Returns ``(gv or None, d_loc [B, M, 2])``, ``d_loc`` in ``(y, x)`` order
    as the location gradient of ``loc``."""
    _check("maps", maps, 4)
    _check("loc", loc, 3, 2)
    _check("values", values, 3)
    b, h, w, c = maps.shape
    m = loc.shape[1]
    if loc.shape[0] != b or values.shape != (b, m, c):
        raise ValueError("maps, loc and values disagree on [B, M, C]")
    if not _on_card(maps, loc, values):
        return gather_fused_dloc_plain(maps, loc, values, with_gv)
    _channels("fused gather", c)
    dev = maps.device
    gv = (torch.empty(b, m, c, dtype=torch.float32, device=dev)
          if with_gv else None)
    d_loc = torch.empty(b, m, 2, dtype=torch.float32, device=dev)
    if b * m == 0:
        return gv, d_loc
    _launch(_library().tef_gather_fused, "gather_fused", dev, maps.data_ptr(),
            loc.data_ptr(), values.data_ptr(),
            None if gv is None else gv.data_ptr(), d_loc.data_ptr(), b, m, c,
            h, w)
    return gv, d_loc


def gather_fused(maps, loc, values, with_gv: bool = True):
    """:func:`gather_fused_dloc` as ``(gv, dy [B, M], dx [B, M])``, ``dy``
    and ``dx`` the columns of its ``d_loc``."""
    gv, d_loc = gather_fused_dloc(maps, loc, values, with_gv)
    return gv, d_loc[..., 0], d_loc[..., 1]


def row_gather(table, idx):
    """Row gather (see :func:`row_gather_plain`): the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. No path differentiates
    through it (the count input and the per-event flow lookup are
    constants), so a table that requires grad raises under grad mode
    instead of being detached quietly."""
    _check("table", table, 2)
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError(f"idx must be contiguous [M], got {tuple(idx.shape)}")
    if torch.is_grad_enabled() and table.requires_grad:
        raise RuntimeError("row_gather has no gradient; detach the table")
    r, w = table.shape
    m = idx.shape[0]
    if r == 0 and m > 0:
        raise ValueError("cannot gather from an empty table")
    if not _on_card(table, idx):
        return row_gather_plain(table, idx)
    out = torch.empty(m, w, dtype=torch.float32, device=table.device)
    if m * w == 0:
        return out
    _launch(_library().tef_row_gather, "row_gather", table.device,
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), m, r, w)
    return out


# ------------------------------------------------------------------ autograd


def _cot(g):
    # cotangents arrive as strided views (flip, slices): the kernels take
    # contiguous float32
    return g.float().contiguous()


class SplatBilinearFn(torch.autograd.Function):
    """Differentiable splat, the counterpart of ``_splat_vjp``
    (``pallas_warp.py:394-417``): the backward is one fused gather of the
    cotangent image, ``(d_values, d_loc) = gather_fused_dloc(g, loc,
    values)``; without a location gradient, a plain gather of ``g``."""

    @staticmethod
    def forward(ctx, loc, values, res):
        ctx.save_for_backward(loc, values)
        return splat_bilinear(loc, values, res)

    @staticmethod
    def backward(ctx, g):
        loc, values = ctx.saved_tensors
        need_loc, need_values = ctx.needs_input_grad[:2]
        g = _cot(g)
        d_loc = d_values = None
        if need_loc:
            d_values, d_loc = gather_fused_dloc(g, loc, values,
                                                with_gv=need_values)
        elif need_values:
            d_values = gather_bilinear(g, loc)
        return d_loc, d_values, None


class GatherBilinearFn(torch.autograd.Function):
    """Differentiable gather, the counterpart of ``_gather_vjp``
    (``pallas_warp.py:420-443``): ``d_maps = splat_bilinear(loc, g)`` and
    ``(_, d_loc) = gather_fused_dloc(maps, loc, g)``, each only when
    needed."""

    @staticmethod
    def forward(ctx, maps, loc):
        ctx.save_for_backward(maps, loc)
        return gather_bilinear(maps, loc)

    @staticmethod
    def backward(ctx, g):
        maps, loc = ctx.saved_tensors
        need_maps, need_loc = ctx.needs_input_grad[:2]
        g = _cot(g)
        d_maps = d_loc = None
        if need_maps:
            d_maps = splat_bilinear(loc, g, (maps.shape[1], maps.shape[2]))
        if need_loc:
            _, d_loc = gather_fused_dloc(maps, loc, g, with_gv=False)
        return d_maps, d_loc

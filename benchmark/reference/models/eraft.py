"""E-RAFT as plain functions of a parameter dict, with its shapes, its init
scales and its convolutions.

Frozen copy of the repo's plain reference ``tests/reference_eraft.py``
(itself written from E-RAFT, Gehrig et al., 3DV 2021, arXiv 2108.10552,
github.com/uzh-rpg/E-RAFT ``model/eraft.py``, ``update.py``, ``corr.py``,
``extractor.py``), for the options in :data:`FIXED`; a test holds the two
equal (``tests/test_torch_eraft.py``). Its departures from
E-RAFT are that file's: the input's channels are ``num_bins`` (the
system's 2-channel count, not the published 15-bin voxel), no warm start,
the mask head and the upsampling run once for the output, a downsampling
block's norm is ``downsample.1`` alone. The context encoder's BatchNorm
runs in eval mode on the dict's statistics (the benchmark trains no
E-RAFT).

``dtype`` casts the parameters, the input and the carry for the
convolutions, norms and GRU; the correlation, the pyramid, the lookups
(RAFT's ``grid_sample`` sampler), the coordinates, the flow and the
upsampling stay float32, as in the port (``models/eraft.py``). ``quant``,
when given, transforms every convolution's input and weight and the
correlation matmul's two operands first (the controls' lower precision,
the witness's channels-last layout).

Init scales (every weight uniform, :func:`init_bounds`), with the variance
of the model's own init:

* an encoder conv (``fnet.``, ``cnet.``): ``+-sqrt(6 / fan_out)``,
  kaiming-normal's variance over the output fan (RAFT's), bias
  ``+-1 / sqrt(fan_in)`` (torch's default, which RAFT keeps);
* an update-block conv: ``+-1 / sqrt(fan_in)`` for the weight and the bias
  (torch's default);
* a BatchNorm (``cnet``'s): scale within ``+-sqrt(eps)``, shift, running
  mean, running variance and batch count zero, so that the eval-mode
  norm, ``scale x / sqrt(0 + eps)``, is a per-channel scale within +-1.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

FIXED = {"fnet_norm": "instance", "cnet_norm": "batch"}
NUMBERS = ("num_bins", "iters", "corr_levels", "corr_radius", "hidden_dim",
           "context_dim", "fnet_dim")
ENCODER_WIDTHS = (64, 96, 128)
MOTION_DIM = 128
BN_EPS = 1e-5
MIN_SIZE = 32


def _blocks(cfg: Dict):
    """Each encoder's convs in the port's order: ``(name, c_in, c_out, k,
    stride, norm, scale)``, ``norm`` the name of the norm after it or
    ``None``, ``scale`` the factor its output is below the input's size."""
    out = []
    for enc, dim in (("fnet", cfg["fnet_dim"]),
                     ("cnet", cfg["hidden_dim"] + cfg["context_dim"])):
        convs = [(enc + ".conv1", cfg["num_bins"], ENCODER_WIDTHS[0], 7, 2,
                  enc + ".norm1", 2)]
        cin = ENCODER_WIDTHS[0]
        for stage, width in enumerate(ENCODER_WIDTHS, 1):
            for blk in (0, 1):
                pre = f"{enc}.layer{stage}.{blk}"
                stride = 2 if blk == 0 and stage > 1 else 1
                scale = 2 ** stage
                convs.append((pre + ".conv1", cin, width, 3, stride,
                              pre + ".norm1", scale))
                convs.append((pre + ".conv2", width, width, 3, 1,
                              pre + ".norm2", scale))
                if stride == 2:
                    convs.append((pre + ".downsample.0", cin, width, 1, 2,
                                  pre + ".downsample.1", scale))
                cin = width
        convs.append((enc + ".conv2", cin, dim, 1, 1, None, 8))
        out.append((enc, convs))
    return out


def _update_convs(cfg: Dict):
    """The update block's convs: ``(name, c_in, c_out, (kh, kw))``."""
    hdim = cfg["hidden_dim"]
    planes = cfg["corr_levels"] * (2 * cfg["corr_radius"] + 1) ** 2
    pre = "update_block."
    gru_in = hdim + cfg["context_dim"] + MOTION_DIM
    convs = [(pre + "encoder.convc1", planes, 256, (1, 1)),
             (pre + "encoder.convc2", 256, 192, (3, 3)),
             (pre + "encoder.convf1", 2, 128, (7, 7)),
             (pre + "encoder.convf2", 128, 64, (3, 3)),
             (pre + "encoder.conv", 64 + 192, MOTION_DIM - 2, (3, 3))]
    for axis, k in (("1", (1, 5)), ("2", (5, 1))):
        convs += [(f"{pre}gru.conv{g}{axis}", gru_in, hdim, k) for g in "zrq"]
    convs += [(pre + "flow_head.conv1", hdim, 256, (3, 3)),
              (pre + "flow_head.conv2", 256, 2, (3, 3)),
              (pre + "mask.0", hdim, 256, (3, 3)),
              (pre + "mask.2", 256, 64 * 9, (1, 1))]
    return convs


def weight_shapes(cfg: Dict) -> Dict[str, tuple]:
    """Name -> shape of every entry of the port's ``state_dict`` (the
    BatchNorm statistics and batch count included, which the program
    loads strictly), computed from ``cfg``'s widths."""
    shapes = {}
    for enc, convs in _blocks(cfg):
        for name, cin, cout, k, _, norm, _ in convs:
            shapes[name + ".weight"] = (cout, cin, k, k)
            shapes[name + ".bias"] = (cout,)
            if norm is not None and enc == "cnet":
                for leaf in ("weight", "bias", "running_mean",
                             "running_var"):
                    shapes[f"{norm}.{leaf}"] = (cout,)
                shapes[norm + ".num_batches_tracked"] = ()
    for name, cin, cout, (kh, kw) in _update_convs(cfg):
        shapes[name + ".weight"] = (cout, cin, kh, kw)
        shapes[name + ".bias"] = (cout,)
    return shapes


def init_bounds(name: str, shape: tuple, cfg: Dict):
    """``(weight bound, bias bound)`` of the layer whose ``.weight`` is
    ``name`` (the module docstring's scales); ``None`` for every other
    entry (its layer's weight gives it)."""
    if not name.endswith(".weight"):
        return None
    if len(shape) == 1:  # a BatchNorm scale
        return math.sqrt(BN_EPS), 0.0
    fan_in = shape[1] * shape[2] * shape[3]
    bias = 1.0 / math.sqrt(fan_in)
    if name.startswith(("fnet.", "cnet.")):
        return math.sqrt(6.0 / (shape[0] * shape[2] * shape[3])), bias
    return bias, bias


def _padded(n: int) -> int:
    return n + (MIN_SIZE - n % MIN_SIZE) % MIN_SIZE


def conv_layers(cfg: Dict, height: int, width: int) -> List[tuple]:
    """Every convolution of one pass at an ``H x W`` input: ``(c_in, c_out,
    k, h_out, w_out, first)``. ``fnet`` counts twice (both volumes), the
    update block ``iters`` times and its mask head once; a ``kh x kw``
    kernel is ``(c_in kh kw, c_out, 1, ...)``, which counts the same
    operations; the correlation matmul is a 1x1 convolution of ``C`` to
    ``h w`` channels at ``h x w``, whose count is the matmul's."""
    h, w = _padded(height), _padded(width)
    layers = []
    for enc, convs in _blocks(cfg):
        for name, cin, cout, k, _, _, scale in convs:
            layers += [(cin, cout, k, h // scale, w // scale,
                        name == enc + ".conv1")] * (2 if enc == "fnet" else 1)
    h8, w8 = h // 8, w // 8
    layers.append((cfg["fnet_dim"], h8 * w8, 1, h8, w8, False))
    for name, cin, cout, (kh, kw) in _update_convs(cfg):
        n = 1 if ".mask." in name else cfg["iters"]
        layers += [(cin * kh * kw, cout, 1, h8, w8, False)] * n
    return layers


def _conv(p, name, x, stride=1, padding=0, quant=None):
    wt = p[name + ".weight"]
    if quant is not None:
        x, wt = quant(x), quant(wt)
    return F.conv2d(x, wt, p[name + ".bias"], stride=stride, padding=padding)


def _norm(p, name, x, kind):
    if kind == "instance":
        return F.instance_norm(x, eps=BN_EPS)
    return F.batch_norm(x, p[name + ".running_mean"],
                        p[name + ".running_var"], p[name + ".weight"],
                        p[name + ".bias"], training=False, eps=BN_EPS)


def _residual(p, pre, x, kind, stride, quant):
    y = F.relu(_norm(p, pre + ".norm1", _conv(p, pre + ".conv1", x, stride,
                                              1, quant), kind))
    y = F.relu(_norm(p, pre + ".norm2", _conv(p, pre + ".conv2", y, 1, 1,
                                              quant), kind))
    if stride != 1:
        x = _norm(p, pre + ".downsample.1",
                  _conv(p, pre + ".downsample.0", x, stride, quant=quant),
                  kind)
    return F.relu(x + y)


def encoder(p, pre, x, kind, quant=None):
    """RAFT's ``BasicEncoder``."""
    x = F.relu(_norm(p, pre + ".norm1", _conv(p, pre + ".conv1", x, 2, 3,
                                              quant), kind))
    for stage, stride in ((1, 1), (2, 2), (3, 2)):
        x = _residual(p, f"{pre}.layer{stage}.0", x, kind, stride, quant)
        x = _residual(p, f"{pre}.layer{stage}.1", x, kind, 1, quant)
    return _conv(p, pre + ".conv2", x, quant=quant)


def coords_grid(batch, ht, wd, device):
    """RAFT's ``coords_grid``: ``[B, 2, H, W]``, channel 0 x, channel 1 y."""
    coords = torch.meshgrid(torch.arange(ht, device=device),
                            torch.arange(wd, device=device), indexing="ij")
    coords = torch.stack(coords[::-1], dim=0).float()
    return coords[None].repeat(batch, 1, 1, 1)


def bilinear_sampler(img, coords):
    """RAFT's ``bilinear_sampler``: ``img [N, C, H, W]`` at pixel
    ``coords [N, h, w, 2]`` (x, y)."""
    h, w = img.shape[-2:]
    xgrid, ygrid = coords.split([1, 1], dim=-1)
    xgrid = 2 * xgrid / (w - 1) - 1
    ygrid = 2 * ygrid / (h - 1) - 1
    grid = torch.cat([xgrid, ygrid], dim=-1)
    return F.grid_sample(img, grid, align_corners=True)


def corr_pyramid(fmap1, fmap2, levels, quant=None):
    """RAFT's ``CorrBlock.__init__``: ``[B h w, 1, h_l, w_l]`` volumes."""
    if quant is not None:
        fmap1, fmap2 = quant(fmap1), quant(fmap2)
    b, dim, ht, wd = fmap1.shape
    corr = torch.matmul(fmap1.reshape(b, dim, ht * wd).transpose(1, 2),
                        fmap2.reshape(b, dim, ht * wd))
    corr = (corr / torch.sqrt(torch.tensor(dim).float())).reshape(
        b * ht * wd, 1, ht, wd)
    pyramid = [corr]
    for _ in range(levels - 1):
        corr = F.avg_pool2d(corr, 2, stride=2)
        pyramid.append(corr)
    return pyramid


def corr_lookup(pyramid, coords, r):
    """RAFT's ``CorrBlock.__call__``: ``coords [B, 2, h, w]`` ->
    ``[B, levels (2r + 1)^2, h, w]``."""
    coords = coords.permute(0, 2, 3, 1)
    batch, h1, w1, _ = coords.shape
    out = []
    for i, corr in enumerate(pyramid):
        dx = torch.linspace(-r, r, 2 * r + 1, device=coords.device)
        dy = torch.linspace(-r, r, 2 * r + 1, device=coords.device)
        delta = torch.stack(torch.meshgrid(dy, dx, indexing="ij"), dim=-1)
        centroid = coords.reshape(batch * h1 * w1, 1, 1, 2) / 2 ** i
        corr = bilinear_sampler(corr, centroid + delta.view(
            1, 2 * r + 1, 2 * r + 1, 2))
        out.append(corr.view(batch, h1, w1, -1))
    return torch.cat(out, dim=-1).permute(0, 3, 1, 2).contiguous().float()


def _sep_gru(p, pre, h, x, quant):
    for axis, pad in (("1", (0, 2)), ("2", (2, 0))):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(_conv(p, f"{pre}.convz{axis}", hx, padding=pad,
                                quant=quant))
        r = torch.sigmoid(_conv(p, f"{pre}.convr{axis}", hx, padding=pad,
                                quant=quant))
        q = torch.tanh(_conv(p, f"{pre}.convq{axis}",
                             torch.cat([r * h, x], dim=1), padding=pad,
                             quant=quant))
        h = (1 - z) * h + z * q
    return h


def update_block(p, net, inp, corr, flow, quant=None):
    """RAFT's ``BasicUpdateBlock`` without the mask head: ``(net,
    delta_flow)``."""
    pre = "update_block.encoder"
    cor = F.relu(_conv(p, pre + ".convc1", corr, quant=quant))
    cor = F.relu(_conv(p, pre + ".convc2", cor, padding=1, quant=quant))
    flo = F.relu(_conv(p, pre + ".convf1", flow, padding=3, quant=quant))
    flo = F.relu(_conv(p, pre + ".convf2", flo, padding=1, quant=quant))
    out = F.relu(_conv(p, pre + ".conv", torch.cat([cor, flo], dim=1),
                       padding=1, quant=quant))
    motion = torch.cat([out, flow], dim=1)
    net = _sep_gru(p, "update_block.gru", net,
                   torch.cat([inp, motion], dim=1), quant)
    delta = _conv(p, "update_block.flow_head.conv2",
                  F.relu(_conv(p, "update_block.flow_head.conv1", net,
                               padding=1, quant=quant)), padding=1,
                  quant=quant)
    return net, delta


def upsample_flow(flow, mask):
    """RAFT's ``upsample_flow``: ``[N, 2, H, W]`` -> ``[N, 2, 8H, 8W]``."""
    n, _, h, w = flow.shape
    mask = torch.softmax(mask.view(n, 1, 9, 8, 8, h, w), dim=2)
    up = F.unfold(8 * flow, [3, 3], padding=1).view(n, 2, 9, 1, 1, h, w)
    up = torch.sum(mask * up, dim=2).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(n, 2, 8 * h, 8 * w)


def init_state(cfg: Dict, batch, height, width, dtype=torch.float32,
               device=None):
    """The carry: ``(image1,)`` of zeros at the padded size."""
    return (torch.zeros(batch, cfg["num_bins"], _padded(height),
                        _padded(width), dtype=dtype, device=device),)


def forward(params: Dict[str, torch.Tensor], cfg: Dict, x, state,
            dtype: Optional[torch.dtype] = None,
            quant: Optional[Callable] = None, finest_only: bool = False):
    """One pass: ``x [B, H, W, C]`` and the carry -> ``(flows [1, B, H, W,
    2] float32 in pixels, (x, y), new carry)``; E-RAFT has one scale, so
    ``finest_only`` changes nothing."""
    p = params
    if dtype is not None:
        p = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in params.items()}
        x = x.to(dtype)
    ph = _padded(x.shape[1]) - x.shape[1]
    pw = _padded(x.shape[2]) - x.shape[2]
    image2 = F.pad(x.permute(0, 3, 1, 2), (pw, 0, ph, 0)).contiguous()
    image1 = state[0].to(image2.dtype)
    b = image2.shape[0]
    hdim = cfg["hidden_dim"]
    fmaps = encoder(p, "fnet", torch.cat([image1, image2]), "instance",
                    quant)
    fmap1, fmap2 = fmaps[:b].float(), fmaps[b:].float()
    pyramid = corr_pyramid(fmap1, fmap2, cfg["corr_levels"], quant)
    net, inp = torch.split(encoder(p, "cnet", image2, "batch", quant),
                           [hdim, cfg["context_dim"]], dim=1)
    net, inp = torch.tanh(net), torch.relu(inp)
    ht, wd = fmap1.shape[2:]
    coords0 = coords_grid(b, ht, wd, x.device)
    coords1 = coords_grid(b, ht, wd, x.device)
    for _ in range(cfg["iters"]):
        coords1 = coords1.detach()
        corr = corr_lookup(pyramid, coords1, cfg["corr_radius"])
        flow = coords1 - coords0
        net, delta = update_block(p, net, inp, corr.to(net.dtype),
                                  flow.to(net.dtype), quant)
        coords1 = coords1 + delta.float()
    mask = _conv(p, "update_block.mask.2",
                 F.relu(_conv(p, "update_block.mask.0", net, padding=1,
                              quant=quant)), quant=quant)
    flow_up = upsample_flow(coords1 - coords0, 0.25 * mask.float())
    flow_up = flow_up[:, :, ph:, pw:].permute(0, 2, 3, 1)
    return flow_up[None], (image2,)

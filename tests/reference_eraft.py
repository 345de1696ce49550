"""A plain reference of E-RAFT (Gehrig et al., 3DV 2021, arXiv 2108.10552;
github.com/uzh-rpg/E-RAFT ``model/eraft.py``, ``model/update.py``,
``model/corr.py``, ``model/extractor.py``): its forward pass as plain
``torch`` functions of a parameter dict in the port's ``state_dict``
naming, written from the published description. It imports no kernel of
the port and no JAX; it computes in float32 with TF32 off for matrix
products and cuDNN (:func:`no_tf32`), and the correlation lookup is RAFT's
own ``bilinear_sampler``: ``F.grid_sample(align_corners=True)`` at
coordinates normalised by ``2 x / (W - 1) - 1``.

One pass: ``image1`` (the carry, the previous pass's input padded to a
multiple of 32 at the top and left) and ``image2`` (this pass's) through
the feature encoder (instance norm), ``image2`` through the context
encoder (batch norm), the all-pairs correlation and its 4-level pyramid,
``iters`` refinements (radius-4 lookup, motion encoder, separable ConvGRU,
flow head) from a zero flow, and the convex 8x upsampling. ``dtype``
(bfloat16) casts the parameters, the input and the carry for the
convolutions, norms and GRU; the correlation, the pyramid, the lookups, the
coordinates, the flow and the upsampling stay float32, as RAFT's
mixed-precision path keeps them.

Departures from E-RAFT:

* the input is the 2-channel per-polarity count, not the 15-bin voxel
  grid (``cfg["num_bins"]``);
* no warm start: every pass starts from a zero flow (E-RAFT's ``standard``
  variant, no ``flow_init``);
* the mask head and the upsampling run once, for the output, where RAFT
  runs them at every iteration and keeps the last at test time;
* the BatchNorm statistics are whatever the parameter dict holds; the
  benchmark's are zero means, zero variances and scales within
  ``+-sqrt(eps)`` (``benchmark/reference/models/eraft.py``);
* a downsampling block's norm is named ``downsample.1`` alone (RAFT also
  registers it as ``norm3``).

RAFT's sampler divides by ``W - 1`` and ``H - 1``, so every pyramid level
must be at least 2 pixels on each side (the input padded to at least
128 x 128 at 4 levels).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

ENCODER_WIDTHS = (64, 96, 128)
BN_EPS = 1e-5
BN_MOMENTUM = 0.1
MIN_SIZE = 32


def no_tf32() -> None:
    """Float32 convolutions and matrix products without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _conv(p, name, x, stride=1, padding=0):
    return F.conv2d(x, p[name + ".weight"], p[name + ".bias"],
                    stride=stride, padding=padding)


def _norm(p, name, x, kind, training):
    if kind == "instance":
        return F.instance_norm(x, eps=BN_EPS)
    return F.batch_norm(x, p[name + ".running_mean"],
                        p[name + ".running_var"], p[name + ".weight"],
                        p[name + ".bias"], training=training,
                        momentum=BN_MOMENTUM, eps=BN_EPS)


def _residual(p, pre, x, kind, stride, training):
    y = F.relu(_norm(p, pre + ".norm1",
                     _conv(p, pre + ".conv1", x, stride, 1), kind, training))
    y = F.relu(_norm(p, pre + ".norm2", _conv(p, pre + ".conv2", y, 1, 1),
                     kind, training))
    if stride != 1:
        x = _norm(p, pre + ".downsample.1",
                  _conv(p, pre + ".downsample.0", x, stride), kind, training)
    return F.relu(x + y)


def encoder(p, pre, x, kind, training=False):
    """RAFT's ``BasicEncoder``: 7x7/2 conv, norm, ReLU, three stages of two
    residual blocks (64, 96, 128 channels; the 2nd and 3rd start with
    stride 2), 1x1 conv."""
    x = F.relu(_norm(p, pre + ".norm1", _conv(p, pre + ".conv1", x, 2, 3),
                     kind, training))
    for stage, stride in ((1, 1), (2, 2), (3, 2)):
        x = _residual(p, f"{pre}.layer{stage}.0", x, kind, stride, training)
        x = _residual(p, f"{pre}.layer{stage}.1", x, kind, 1, training)
    return _conv(p, pre + ".conv2", x)


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


def corr_pyramid(fmap1, fmap2, levels):
    """RAFT's ``CorrBlock.__init__``: ``[B h w, 1, h_l, w_l]`` volumes."""
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


def _sep_gru(p, pre, h, x):
    for axis, pad in (("1", (0, 2)), ("2", (2, 0))):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(_conv(p, f"{pre}.convz{axis}", hx, padding=pad))
        r = torch.sigmoid(_conv(p, f"{pre}.convr{axis}", hx, padding=pad))
        q = torch.tanh(_conv(p, f"{pre}.convq{axis}",
                             torch.cat([r * h, x], dim=1), padding=pad))
        h = (1 - z) * h + z * q
    return h


def update_block(p, net, inp, corr, flow):
    """RAFT's ``BasicUpdateBlock`` without the mask head: ``(net,
    delta_flow)``."""
    pre = "update_block.encoder"
    cor = F.relu(_conv(p, pre + ".convc1", corr))
    cor = F.relu(_conv(p, pre + ".convc2", cor, padding=1))
    flo = F.relu(_conv(p, pre + ".convf1", flow, padding=3))
    flo = F.relu(_conv(p, pre + ".convf2", flo, padding=1))
    out = F.relu(_conv(p, pre + ".conv", torch.cat([cor, flo], dim=1),
                       padding=1))
    motion = torch.cat([out, flow], dim=1)
    net = _sep_gru(p, "update_block.gru", net,
                   torch.cat([inp, motion], dim=1))
    delta = _conv(p, "update_block.flow_head.conv2",
                  F.relu(_conv(p, "update_block.flow_head.conv1", net,
                               padding=1)), padding=1)
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
    height += (MIN_SIZE - height % MIN_SIZE) % MIN_SIZE
    width += (MIN_SIZE - width % MIN_SIZE) % MIN_SIZE
    return (torch.zeros(batch, cfg["num_bins"], height, width, dtype=dtype,
                        device=device),)


def forward(params: Dict[str, torch.Tensor], cfg: Dict, x, state,
            dtype: Optional[torch.dtype] = None, training: bool = False):
    """One pass: ``x [B, H, W, C]`` and the carry -> ``(flows [1, B, H, W,
    2] float32 in pixels, (x, y), new carry)``. With ``training`` the
    context encoder's BatchNorm uses the batch's statistics and updates the
    running ones in ``params``."""
    p = params
    if dtype is not None:
        p = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in params.items()}
        x = x.to(dtype)
    h_in, w_in = x.shape[1], x.shape[2]
    ph = (MIN_SIZE - h_in % MIN_SIZE) % MIN_SIZE
    pw = (MIN_SIZE - w_in % MIN_SIZE) % MIN_SIZE
    image2 = F.pad(x.permute(0, 3, 1, 2), (pw, 0, ph, 0)).contiguous()
    image1 = state[0].to(image2.dtype)
    b = image2.shape[0]
    hdim = cfg["hidden_dim"]
    fmaps = encoder(p, "fnet", torch.cat([image1, image2]), "instance",
                    training)
    fmap1, fmap2 = fmaps[:b].float(), fmaps[b:].float()
    pyramid = corr_pyramid(fmap1, fmap2, cfg["corr_levels"])
    net, inp = torch.split(encoder(p, "cnet", image2, "batch", training),
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
                                  flow.to(net.dtype))
        coords1 = coords1 + delta.float()
    mask = _conv(p, "update_block.mask.2",
                 F.relu(_conv(p, "update_block.mask.0", net, padding=1)))
    flow_up = upsample_flow(coords1 - coords0, 0.25 * mask.float())
    flow_up = flow_up[:, :, ph:, pw:].permute(0, 2, 3, 1)
    return flow_up[None], (image2,)

"""E-RAFT (Gehrig, Millhaeusler, Gehrig and Scaramuzza, "E-RAFT: Dense
Optical Flow from Event Cameras", 3DV 2021; github.com/uzh-rpg/E-RAFT
``model/eraft.py``, ``update.py``, ``corr.py``, ``extractor.py``): RAFT
(Teed and Deng, ECCV 2020) on event volumes, NCHW inside, with the port's
interface: ``forward(x [B, H, W, C], carry) -> (flows [1, B, H, W, 2],
carry)``, flows in pixels, (x, y) order.

A pass pads its input to a multiple of 32 at the top and left (E-RAFT's
``ImagePadder``), takes the previous pass's padded input from the carry as
``image1`` (zeros after :meth:`ERAFT.init_state`) and its own as
``image2``, and runs:

* two residual encoders at 1/8 resolution: ``fnet`` (instance norm, 256
  channels out) on both volumes as one batch, ``cnet`` (batch norm, hidden
  + context channels) on ``image2``; ``net = tanh``, ``inp = relu`` of its
  split;
* the all-pairs correlation ``fmap1^T fmap2 / sqrt(C)`` and its pyramid of
  ``2 x 2`` average pools (:func:`corr_pyramid`);
* ``iters`` refinements from a zero flow: the radius-``r`` lookup of every
  level around the current estimate (:func:`lookup`, one call of the port's
  bilinear gather per level), the motion encoder, the separable ConvGRU and
  the flow head, the coordinates detached at each iteration;
* the convex 8x upsampling of the last estimate (:func:`upsample_flow`).

RAFT also computes the mask head and the upsampling at every iteration
and keeps only the last at test time; here they run once, for the output,
which is the same result. RAFT's ``norm3`` alias of a downsampling block's
norm is not registered twice: the norm is ``downsample.1`` alone.

Precision: in a model cast to bfloat16 (``training/step.py: _eval_net``)
the convolutions, the norms and the GRU compute in bfloat16, while the
correlation, the pyramid, the lookups, the coordinates, the flow and the
upsampling stay float32, as RAFT's mixed-precision path keeps them.

Modes: ``cnet``'s BatchNorm normalises by the batch's statistics in
training mode and by its running statistics in eval mode, so a training
step and an eval pass compute different things; each step runs the mode
it needs (``training/step.py``).

While a profile is active a pass records the spans ``eraft.encode`` (both
encoders), ``eraft.corr`` (volume and pyramid), ``eraft.refine`` (the
iterations) and ``eraft.upsample``, and the counter ``corr_taps`` (the
taps one iteration looks up, ``B h w levels (2r + 1)^2``) at each
iteration.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.warp import gather_values
# the module, not its names: utils.diagnostics imports tracking, which
# imports this package, so it may still be loading when this file runs
from ..utils import diagnostics
from .model import pad_to_multiple, unpad

MIN_SIZE = 32  # E-RAFT's ImagePadder(min_size=32)
ENCODER_WIDTHS = (64, 96, 128)  # RAFT's BasicEncoder stages
MOTION_DIM = 128  # the motion encoder's output, flow included


def _norm(kind: str, channels: int) -> nn.Module:
    return (nn.InstanceNorm2d(channels) if kind == "instance"
            else nn.BatchNorm2d(channels))


def _default_init(conv: nn.Conv2d, gen: torch.Generator) -> None:
    """torch's own Conv2d initialisation, drawn from ``gen``."""
    nn.init.kaiming_uniform_(conv.weight, a=math.sqrt(5), generator=gen)
    bound = 1.0 / math.sqrt(conv.weight[0].numel())
    nn.init.uniform_(conv.bias, -bound, bound, generator=gen)


class ResidualBlock(nn.Module):
    """RAFT ``extractor.py: ResidualBlock``: two 3x3 convs with norms, and
    a strided 1x1 conv with a norm on the shortcut when ``stride > 1``."""

    def __init__(self, in_planes: int, planes: int, norm: str,
                 stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, padding=1,
                               stride=stride)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.norm1 = _norm(norm, planes)
        self.norm2 = _norm(norm, planes)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride),
                _norm(norm, planes))

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """RAFT ``extractor.py: BasicEncoder`` (E-RAFT's ``n_first_channels``
    input): a 7x7 stride-2 conv, three stages of two residual blocks (64,
    96, 128 channels, the last two strided), a 1x1 conv to ``output_dim``,
    at 1/8 of the input's size. No dropout (E-RAFT's is 0)."""

    def __init__(self, in_channels: int, output_dim: int, norm: str):
        super().__init__()
        c1, c2, c3 = ENCODER_WIDTHS
        self.conv1 = nn.Conv2d(in_channels, c1, 7, stride=2, padding=3)
        self.norm1 = _norm(norm, c1)
        self.layer1 = nn.Sequential(ResidualBlock(c1, c1, norm),
                                    ResidualBlock(c1, c1, norm))
        self.layer2 = nn.Sequential(ResidualBlock(c1, c2, norm, 2),
                                    ResidualBlock(c2, c2, norm))
        self.layer3 = nn.Sequential(ResidualBlock(c2, c3, norm, 2),
                                    ResidualBlock(c3, c3, norm))
        self.conv2 = nn.Conv2d(c3, output_dim, 1)

    def init_weights(self, gen: torch.Generator):
        # RAFT's: kaiming-normal conv weights (fan out, relu) over torch's
        # default biases, norm scales one and shifts zero
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                _default_init(m, gen)
                nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                        nonlinearity="relu", generator=gen)
            elif isinstance(m, nn.BatchNorm2d):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)


class MotionEncoder(nn.Module):
    """RAFT ``update.py: BasicMotionEncoder``: the looked-up correlation
    (1x1 to 256, 3x3 to 192) and the flow (7x7 to 128, 3x3 to 64), merged
    by a 3x3 conv to 126 channels, with the flow appended."""

    def __init__(self, corr_planes: int):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_planes, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, MOTION_DIM - 2, 3, padding=1)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class SepConvGRU(nn.Module):
    """RAFT ``update.py: SepConvGRU``: a GRU step with (1x5) gates, then one
    with (5x1) gates."""

    def __init__(self, hidden_dim: int, input_dim: int):
        super().__init__()
        cin = hidden_dim + input_dim
        for axis, (k, p) in (("1", ((1, 5), (0, 2))),
                             ("2", ((5, 1), (2, 0)))):
            for gate in "zrq":
                setattr(self, f"conv{gate}{axis}",
                        nn.Conv2d(cin, hidden_dim, k, padding=p))

    def _step(self, h, x, convz, convr, convq):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(convz(hx))
        r = torch.sigmoid(convr(hx))
        q = torch.tanh(convq(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q

    def forward(self, h, x):
        h = self._step(h, x, self.convz1, self.convr1, self.convq1)
        return self._step(h, x, self.convz2, self.convr2, self.convq2)


class FlowHead(nn.Module):
    """RAFT ``update.py: FlowHead``: 3x3 to 256, ReLU, 3x3 to 2."""

    def __init__(self, input_dim: int, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, 2, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class UpdateBlock(nn.Module):
    """RAFT ``update.py: BasicUpdateBlock``: the motion encoder, the GRU
    over the context and the motion features, the flow head, and the mask
    head (3x3 to 256, ReLU, 1x1 to 64 x 9), which :class:`ERAFT` runs
    after the last iteration only."""

    def __init__(self, corr_planes: int, hidden_dim: int, context_dim: int):
        super().__init__()
        self.encoder = MotionEncoder(corr_planes)
        self.gru = SepConvGRU(hidden_dim, context_dim + MOTION_DIM)
        self.flow_head = FlowHead(hidden_dim)
        self.mask = nn.Sequential(nn.Conv2d(hidden_dim, 256, 3, padding=1),
                                  nn.ReLU(inplace=True),
                                  nn.Conv2d(256, 64 * 9, 1))

    def init_weights(self, gen: torch.Generator):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                _default_init(m, gen)

    def forward(self, net, inp, corr, flow):
        """``(net, delta_flow)``: the GRU's new hidden state and the flow
        head's update."""
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, self.flow_head(net)


def coords_grid(batch: int, height: int, width: int, device):
    """RAFT's ``coords_grid``: float32 ``[B, 2, H, W]``, channel 0 the x
    and channel 1 the y of each pixel."""
    y, x = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij")
    return torch.stack([x, y])[None].expand(batch, -1, -1, -1)


def corr_pyramid(fmap1, fmap2, levels: int):
    """RAFT ``corr.py: CorrBlock.__init__`` in float32: the all-pairs
    volume ``fmap1^T fmap2 / sqrt(C)`` of ``[B, C, h, w]`` maps as one map
    per query position, ``[B h w, h, w, 1]``, then ``levels - 1`` 2x2
    average pools of it. Returns the ``levels`` maps, finest first."""
    b, c, h, w = fmap1.shape
    corr = torch.matmul(fmap1.float().reshape(b, c, h * w).transpose(1, 2),
                        fmap2.float().reshape(b, c, h * w))
    corr = (corr / math.sqrt(c)).reshape(b * h * w, 1, h, w)
    pyramid = [corr]
    for _ in range(levels - 1):
        corr = F.avg_pool2d(corr, 2, stride=2)
        pyramid.append(corr)
    # a map of one channel is the same memory NCHW and NHWC
    return [p.reshape(p.shape[0], p.shape[2], p.shape[3], 1)
            for p in pyramid]


def tap_offsets(radius: int, device):
    """The ``(2r + 1)^2`` lookup offsets in RAFT's order, ``[K, 2]`` in the
    gather's (y, x): RAFT stacks ``meshgrid(dy, dx)`` and adds it to (x, y)
    coordinates, so the x offset runs on the slower axis and the y offset
    on the faster."""
    d = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=device)
    n = 2 * radius + 1
    return torch.stack([d.repeat(n), d.repeat_interleave(n)], dim=-1)


def lookup(pyramid, coords, radius: int):
    """RAFT ``corr.py: CorrBlock.__call__``: each level's volume sampled
    bilinearly at the ``(2r + 1)^2`` taps around ``coords / 2^l``
    (``[B, 2, h, w]`` float32 (x, y)), out-of-frame taps zero, by the
    port's gather (``ops.warp.gather_values``: grid_sample's
    ``align_corners=True``, zero-padded, at pixel coordinates). Returns
    float32 ``[B, levels (2r + 1)^2, h, w]``, the levels in order."""
    b, _, h, w = coords.shape
    centre = coords.permute(0, 2, 3, 1).reshape(b * h * w, 1, 2).flip(-1)
    offsets = tap_offsets(radius, coords.device)
    out = [gather_values(corr, centre / 2 ** level + offsets)
           for level, corr in enumerate(pyramid)]
    diagnostics.count("corr_taps",
                      b * h * w * len(pyramid) * offsets.shape[0])
    return torch.cat(out, dim=1).reshape(b, h, w, -1).permute(0, 3, 1, 2)


def upsample_flow(flow, mask):
    """RAFT's ``upsample_flow`` in float32: ``flow [B, 2, h, w]`` to
    ``[B, 8h, 8w, 2]``, each fine pixel a convex combination (softmax over
    9 of ``mask [B, 576, h, w]``) of its coarse 3x3 neighbourhood of ``8
    flow``."""
    b, _, h, w = flow.shape
    mask = torch.softmax(mask.reshape(b, 1, 9, 8, 8, h, w), dim=2)
    up = F.unfold(8 * flow, [3, 3], padding=1).reshape(b, 2, 9, 1, 1, h, w)
    up = torch.sum(mask * up, dim=2)  # [B, 2, 8, 8, h, w]
    return up.permute(0, 4, 2, 5, 3, 1).reshape(b, 8 * h, 8 * w, 2)


class ERAFT(nn.Module):
    """E-RAFT at its published widths by default (the module docstring),
    ``fnet`` with instance norms and ``cnet`` with batch norms as
    published. ``num_bins`` is the input's channel count (E-RAFT's
    ``n_first_channels``); the carry is ``(image1,)``, the previous pass's
    padded input ``[B, C, H_pad, W_pad]``.

    :raises ValueError: for ``fnet_norm`` or ``cnet_norm`` other than the
        published ``instance`` and ``batch``, the only ones built.
    """

    def __init__(self, num_bins: int = 15, iters: int = 12,
                 corr_levels: int = 4, corr_radius: int = 4,
                 hidden_dim: int = 128, context_dim: int = 128,
                 fnet_dim: int = 256, fnet_norm: str = "instance",
                 cnet_norm: str = "batch"):
        super().__init__()
        if (fnet_norm, cnet_norm) != ("instance", "batch"):
            raise ValueError(
                f"ERAFT builds fnet_norm 'instance' and cnet_norm 'batch', "
                f"got {fnet_norm!r} and {cnet_norm!r}")
        self.num_bins = num_bins
        self.iters = iters
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.hidden_dim = hidden_dim
        self.context_dim = context_dim
        self.fnet = BasicEncoder(num_bins, fnet_dim, "instance")
        self.cnet = BasicEncoder(num_bins, hidden_dim + context_dim, "batch")
        self.update_block = UpdateBlock(
            corr_levels * (2 * corr_radius + 1) ** 2, hidden_dim,
            context_dim)

    def forward(self, x, carry):
        x, pads = pad_to_multiple(x, MIN_SIZE)
        image2 = x.permute(0, 3, 1, 2).contiguous()
        image1 = carry[0].to(image2.dtype)
        b = image2.shape[0]
        cdt = self.cnet.conv1.weight.dtype  # what the convolutions run in
        with diagnostics.annotate("eraft.encode"):
            fmap1, fmap2 = self.fnet(torch.cat([image1, image2])).split(b)
            net, inp = self.cnet(image2).split(
                [self.hidden_dim, self.context_dim], dim=1)
            net, inp = torch.tanh(net), torch.relu(inp)
        with diagnostics.annotate("eraft.corr"):
            pyramid = corr_pyramid(fmap1, fmap2, self.corr_levels)
        h, w = fmap1.shape[2:]
        with diagnostics.annotate("eraft.refine"):
            coords0 = coords_grid(b, h, w, x.device)
            coords1 = coords0
            for _ in range(self.iters):
                coords1 = coords1.detach()
                corr = lookup(pyramid, coords1, self.corr_radius)
                net, delta = self.update_block(
                    net, inp, corr.to(cdt), (coords1 - coords0).to(cdt))
                coords1 = coords1 + delta.float()
        with diagnostics.annotate("eraft.upsample"):
            mask = 0.25 * self.update_block.mask(net).float()
            flow = upsample_flow(coords1 - coords0, mask)
        return unpad(flow, pads)[None], (image2,)

    def init_state(self, batch: int, height: int, width: int,
                   dtype=torch.float32, device=None):
        """``(image1,)`` of zeros: no previous input."""
        height += (MIN_SIZE - height % MIN_SIZE) % MIN_SIZE
        width += (MIN_SIZE - width % MIN_SIZE) % MIN_SIZE
        return (torch.zeros(batch, self.num_bins, height, width, dtype=dtype,
                            device=device),)

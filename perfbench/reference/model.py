"""Plain float32 UniDefense models for the benchmark's reference: UDEB4
(EfficientNet-b4) and UDR50 (ResNet-50), written after the port's
``unidefense_torch/models/{layers,efficientnet,resnet,filters,unidefense}.py``
as they stood when the benchmark was made, so that a later change to the
program does not move the yardstick. Module names equal the port's, so one
state dict loads into both.

What differs from the program, on purpose:

- every tensor is float32 (the program computes in bfloat16 where the
  configuration says ``precision: bf16``); only ``Numerics`` rounds, where
  the program holds its compute type: the operands and outputs of
  convolutions and products, the outputs of the norms and of the SFConv
  frequency branch, the pooled means (to float8 in the control, not at all
  in the reference);
- the SFConv frequency branch is its definition, ``irfft2(pack(rfft2(x)) @
  W)`` over cuFFT, not the program's spatial closed form and its kernels;
- training BatchNorm normalises with the batch statistics over every rank's
  rows at once and leaves the running statistics alone (no compared number
  reads them); in eval it normalises with them;
- in training each EfficientNet block and each ResNet bottleneck is
  recomputed in the backward (``torch.utils.checkpoint``), so that the
  float32 step fits the card beside nothing else; the recompute replays the
  forward's masks (``Draws``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference.numerics import Draws, Numerics


def nhwc(x):
    return x.permute(0, 2, 3, 1)


def nchw(x):
    return x.permute(0, 3, 1, 2)


# ------------------------------------------------------------------ layers

def same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """TF static SAME padding, the low half first."""
    pads = []
    for size in (x.shape[3], x.shape[2]):
        total = max((math.ceil(size / s) - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


class Conv(nn.Conv2d):
    def __init__(self, nx: Numerics, cin, cout, k, s=1, padding=0, groups=1, bias=True):
        self.same = padding == "SAME"
        super().__init__(cin, cout, k, s, padding=0 if self.same else padding, groups=groups,
                         bias=bias, device="meta")
        self.nx = nx

    def forward(self, x):
        if self.same:
            x = same_pad(x, self.kernel_size[0], self.stride[0])
        return self.nx(F.conv2d(self.nx(x), self.nx(self.weight), self.bias, self.stride,
                                self.padding, groups=self.groups))


class ConvTranspose(nn.ConvTranspose2d):
    def __init__(self, nx: Numerics, cin, cout):
        super().__init__(cin, cout, 3, 2, 1, 1, bias=False, device="meta")
        self.nx = nx

    def forward(self, x):
        return self.nx(F.conv_transpose2d(self.nx(x), self.nx(self.weight), None, 2, 1, 1))


class BatchNorm(nn.Module):
    """Batch statistics in training (biased variance), running ones in eval.
    ``calibrate``: set the running statistics from the input of the next
    eval forward before normalising with them (the benchmark's weights);
    the frozen-bias bottleneck takes mean 0 and the mean square."""

    def __init__(self, nx: Numerics, n: int, eps: float = 1e-5, frozen_bias: bool = False):
        super().__init__()
        self.nx = nx
        self.eps = eps
        self.frozen_bias = frozen_bias
        self.calibrate = False
        self.weight = nn.Parameter(torch.empty(n, device="meta"))
        self.bias = nn.Parameter(torch.empty(n, device="meta"), requires_grad=not frozen_bias)
        self.register_buffer("running_mean", torch.empty(n, device="meta"))
        self.register_buffer("running_var", torch.empty(n, device="meta"))
        self.register_buffer("num_batches_tracked", torch.empty((), dtype=torch.long,
                                                                device="meta"))

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        dims = (0,) + tuple(range(2, x.dim()))
        if self.training:
            var, mean = torch.var_mean(x, dim=dims, correction=0)
        else:
            if self.calibrate:
                with torch.no_grad():
                    if x.dim() == 2 and self.frozen_bias:
                        self.running_mean.zero_()
                        self.running_var.copy_(x.pow(2).mean(0))
                    else:
                        self.running_mean.copy_(x.mean(dims))
                        self.running_var.copy_(x.var(dims, correction=0))
            mean, var = self.running_mean, self.running_var
        scale = (self.weight * torch.rsqrt(var + self.eps)).view(shape)
        return self.nx((x - mean.view(shape)) * scale + self.bias.view(shape))


class InstanceNorm(nn.Module):
    def __init__(self, nx: Numerics, n: int):
        super().__init__()
        self.nx = nx
        self.weight = nn.Parameter(torch.empty(n, device="meta"))
        self.bias = nn.Parameter(torch.empty(n, device="meta"))

    def forward(self, x):
        var, mean = torch.var_mean(x, dim=(2, 3), keepdim=True, correction=0)
        y = (x - mean) * torch.rsqrt(var + 1e-5)
        return self.nx(y * self.weight.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1))


class Classifier(nn.Module):
    def __init__(self, nx: Numerics, n: int, classes: int):
        super().__init__()
        self.fc = nn.Linear(n, classes, device="meta")
        self.nx = nx

    def forward(self, x):
        return self.nx(F.linear(self.nx(x), self.nx(self.fc.weight), self.fc.bias))


def dropout(x, rate: float, training: bool, draws: Optional[Draws]):
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = draws.rand(x.shape, x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def spectrum(x: torch.Tensor, norm: str = "ortho") -> torch.Tensor:
    """rfft2 over H, W of an NHWC tensor, (real ‖ imag) along channels."""
    z = torch.fft.rfft2(x, dim=(1, 2), norm=norm)
    return torch.cat([z.real, z.imag], dim=-1)


def inverse_spectrum(r: torch.Tensor, s, norm: str = "ortho") -> torch.Tensor:
    c = r.shape[-1] // 2
    return torch.fft.irfft2(torch.complex(r[..., :c], r[..., c:]), s=tuple(s), dim=(1, 2),
                            norm=norm)


def bilinear(x_nhwc, h: int, w: int):
    if tuple(x_nhwc.shape[1:3]) == (h, w):
        return x_nhwc
    return nhwc(F.interpolate(nchw(x_nhwc), size=(h, w), mode="bilinear", align_corners=True))


class SFConv(Conv):
    """A KxK conv blended by sigmoid(sf_coef) with the frequency branch: the
    packed spectrum of the input through a dense (2C, 2C) channel mix and
    back, average-pooled to a strided output."""

    def __init__(self, nx: Numerics, c, k, s=1, padding=0, groups=1):
        super().__init__(nx, c, c, k, s, padding, groups, bias=False)
        self.freq_conv = nn.Conv2d(2 * c, 2 * c, 1, bias=False, device="meta")
        self.sf_coef = nn.Parameter(torch.empty((), device="meta"))

    def forward(self, x):
        spat = super().forward(x)
        xn = nhwc(x)
        w_packed = self.freq_conv.weight[:, :, 0, 0].t()  # rows: packed input channels
        freq = inverse_spectrum(self.nx(spectrum(xn)) @ self.nx(w_packed), xn.shape[1:3])
        freq = nchw(self.nx(freq))
        if freq.shape[2:] != spat.shape[2:]:
            freq = F.adaptive_avg_pool2d(freq, spat.shape[2:])
        coef = torch.sigmoid(self.sf_coef)
        return (1.0 - coef) * spat + coef * freq


def _checkpointed(fn, x, draws: Optional[Draws]):
    """``fn(x)`` recomputed in the backward, its masks replayed."""
    start = None if draws is None else draws.pos

    def run(x):
        if draws is not None:
            draws.pos = start
        return fn(x)

    return checkpoint(run, x, use_reentrant=False)


# ------------------------------------------------------------ EfficientNet

PARAMS = {"efficientnet-b0": (1.0, 1.0), "efficientnet-b4": (1.4, 1.8)}
B0_BLOCKS = [(1, 3, 1, 1, 32, 16), (2, 3, 2, 6, 16, 24), (2, 5, 2, 6, 24, 40),
             (3, 3, 2, 6, 40, 80), (3, 5, 1, 6, 80, 112), (4, 5, 2, 6, 112, 192),
             (1, 3, 1, 6, 192, 320)]  # (repeats, kernel, stride, expand, in, out), SE 0.25
DELIMITER = {"efficientnet-b4": [2, 6, 10, 16, 22, 30, 32]}


def round_filters(f: int, w: float, divisor: int = 8) -> int:
    f *= w
    new = max(divisor, int(f + divisor / 2) // divisor * divisor)
    return int(new + divisor if new < 0.9 * f else new)


@dataclass(frozen=True)
class BlockSpec:
    k: int
    stride: int
    expand: int
    cin: int
    cout: int
    sf: bool


def block_specs(name: str) -> list:
    w, d = PARAMS[name]
    specs = []
    for gid, (r, k, s, e, i, o) in enumerate(B0_BLOCKS):
        fin, fout = round_filters(i, w), round_filters(o, w)
        for rep in range(int(math.ceil(d * r))):
            specs.append(BlockSpec(k, s if rep == 0 else 1, e, fin if rep == 0 else fout, fout,
                                   gid not in (0, 1, len(B0_BLOCKS) - 1)))
    return specs


class MBConvBlock(nn.Module):
    def __init__(self, nx: Numerics, sp: BlockSpec):
        super().__init__()
        self.sp = sp
        oup = sp.cin * sp.expand
        if sp.expand != 1:
            self._expand_conv = Conv(nx, sp.cin, oup, 1, 1, "SAME", bias=False)
            self._bn0 = BatchNorm(nx, oup, eps=1e-3)
        if sp.sf:
            self._depthwise_conv = SFConv(nx, oup, sp.k, sp.stride, "SAME", groups=oup)
        else:
            self._depthwise_conv = Conv(nx, oup, oup, sp.k, sp.stride, "SAME", groups=oup,
                                        bias=False)
        self._bn1 = BatchNorm(nx, oup, eps=1e-3)
        sq = max(1, int(sp.cin * 0.25))
        self._se_reduce = Conv(nx, oup, sq, 1, 1, "SAME")
        self._se_expand = Conv(nx, sq, oup, 1, 1, "SAME")
        self._project_conv = Conv(nx, oup, sp.cout, 1, 1, "SAME", bias=False)
        self._bn2 = BatchNorm(nx, sp.cout, eps=1e-3)

    @property
    def skip(self) -> bool:
        return self.sp.stride == 1 and self.sp.cin == self.sp.cout

    def forward(self, x, rate: float, draws: Optional[Draws]):
        inputs = x
        if self.sp.expand != 1:
            x = F.silu(self._bn0(self._expand_conv(x)))
        x = F.silu(self._bn1(self._depthwise_conv(x)))
        sq = self._se_reduce.nx(x.mean(dim=(2, 3), keepdim=True))
        s = self._se_expand(F.silu(self._se_reduce(sq)))
        x = self._bn2(self._project_conv(torch.sigmoid(s) * x))
        if self.skip:
            if self.training and rate:
                keep = 1.0 - rate
                x = x / keep * torch.floor(keep + draws.rand((x.shape[0], 1, 1, 1), x.device))
            x = x + inputs
        return x


class EfficientNet(nn.Module):
    def __init__(self, nx: Numerics, name: str, drop_connect_rate: float):
        super().__init__()
        w = PARAMS[name][0]
        self.rate = drop_connect_rate
        self.specs = block_specs(name)
        stem, self.head_filters = round_filters(32, w), round_filters(1280, w)
        self._conv_stem = Conv(nx, 3, stem, 3, 2, "SAME", bias=False)
        self._bn0 = BatchNorm(nx, stem, eps=1e-3)
        self._blocks = nn.ModuleList(MBConvBlock(nx, s) for s in self.specs)
        self._conv_head = Conv(nx, self.specs[-1].cout, self.head_filters, 1, 1, "SAME",
                               bias=False)
        self._bn1 = BatchNorm(nx, self.head_filters, eps=1e-3)
        self.recompute = False

    def blocks(self, x, start: int, end: int, draws: Optional[Draws]):
        for i in range(start, end):
            rate = self.rate * float(i) / len(self._blocks)
            block = self._blocks[i]
            if self.recompute and self.training:
                x = _checkpointed(lambda t, b=block, r=rate: b(t, r, draws), x, draws)
            else:
                x = block(x, rate, draws)
        return x


# ------------------------------------------------------------------ ResNet

def _pool(x):
    return F.max_pool2d(x, 3, 2, 1)


class Bottleneck(nn.Module):
    def __init__(self, nx: Numerics, cin: int, planes: int, stride: int, down: bool, sf: bool):
        super().__init__()
        out = planes * 4

        def conv(a, b, k, s, p, use_sf):
            return SFConv(nx, b, k, s, p) if use_sf else Conv(nx, a, b, k, s, p, bias=False)

        self.conv1 = conv(cin, planes, 1, 1, 0, sf and cin == planes)
        self.bn1 = BatchNorm(nx, planes)
        self.conv2 = conv(planes, planes, 3, stride, 1, sf)
        self.bn2 = BatchNorm(nx, planes)
        self.conv3 = conv(planes, out, 1, 1, 0, sf and planes == out)
        self.bn3 = BatchNorm(nx, out)
        self.downsample = nn.Sequential(Conv(nx, cin, out, 1, stride, 0, bias=False),
                                        BatchNorm(nx, out)) if down else None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class ResNetStage(nn.Sequential):
    def __init__(self, nx, cin, planes, n, stride, sf):
        blocks = []
        for i in range(n):
            s = stride if i == 0 else 1
            blocks.append(Bottleneck(nx, cin, planes, s, i == 0 and (s != 1 or cin != planes * 4),
                                     sf))
            cin = planes * 4
        super().__init__(*blocks)
        self.recompute = False

    def forward(self, x):
        for block in self:
            x = _checkpointed(block, x, None) if self.recompute and self.training else block(x)
        return x


class ExtractorRes50(nn.Module):
    """ResNet-50 stem, max-pool and layers 1-3 (1024 channels); SFConv in
    layers 2 and 3 where in and out channels match."""

    def __init__(self, nx: Numerics):
        super().__init__()
        self.conv1 = Conv(nx, 3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(nx, 64)
        self.layer1 = ResNetStage(nx, 64, 64, 3, 1, False)
        self.layer2 = ResNetStage(nx, 256, 128, 4, 2, True)
        self.layer3 = ResNetStage(nx, 512, 256, 6, 2, True)

    def forward(self, x):
        x = _pool(F.relu(self.bn1(self.conv1(x))))
        return self.layer3(self.layer2(self.layer1(x)))


class EmbedderRes50Layer1(nn.Module):
    def __init__(self, nx: Numerics, cin: int = 1024):
        super().__init__()
        self.conv1 = Conv(nx, cin, 512, 1, 1, 0, bias=False)
        self.norm1 = BatchNorm(nx, 512)
        self.conv2 = SFConv(nx, 512, 3, 2, 1)
        self.norm2 = BatchNorm(nx, 512)
        self.conv3 = Conv(nx, 512, 2048, 1, 1, 0, bias=False)
        self.norm3 = BatchNorm(nx, 2048)
        self.downsample = nn.Sequential(Conv(nx, cin, 2048, 1, 1, 0, bias=False),
                                        BatchNorm(nx, 2048))

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        return F.relu(self.norm3(self.conv3(y)) + _pool(self.downsample(x)))


class EmbedderRes50Layer2(nn.Module):
    def __init__(self, nx: Numerics):
        super().__init__()
        self.conv1 = Conv(nx, 2048, 512, 1, 1, 0, bias=False)
        self.norm1 = BatchNorm(nx, 512)
        self.conv2 = SFConv(nx, 512, 3, 1, 1)
        self.norm2 = BatchNorm(nx, 512)
        self.conv3 = Conv(nx, 512, 2048, 1, 1, 0, bias=False)
        self.norm3 = BatchNorm(nx, 2048)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        return F.relu(self.norm3(self.conv3(y)) + x)


# --------------------------------------------------------------- UniDefense

class _Act(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


class DecoderBlock(nn.Sequential):
    def __init__(self, nx, cin, f, out=None, final=False, act=F.silu):
        out = out or f
        layers = [Conv(nx, cin, f, 3, 1, 1, bias=False), InstanceNorm(nx, f), _Act(act),
                  ConvTranspose(nx, f, f), InstanceNorm(nx, f), _Act(act),
                  Conv(nx, f, out, 3, 1, 1, bias=False), InstanceNorm(nx, out), _Act(act)]
        if final:
            layers += [Conv(nx, out, 3, 3, 1, 1, bias=False), _Act(torch.tanh)]
        super().__init__(*layers)


class DynamicFilter(nn.Module):
    def __init__(self, nx, c, diff_c, k, act):
        super().__init__()
        self.act = act
        self.layer1 = nn.Sequential(Conv(nx, c, c, k, 1, k // 2, bias=False), BatchNorm(nx, c))
        self.layer2 = nn.Sequential(Conv(nx, 2 + diff_c, 1, 1, 1, 0, bias=False))

    def forward(self, x, diff):
        proj = self.act(self.layer1(x))
        pre = torch.cat([proj.mean(1, keepdim=True), proj.amax(1, keepdim=True), diff], dim=1)
        mask = torch.sigmoid(self.layer2(pre))
        return mask, mask * x


def _recon_losses(rec, x):
    """Per-sample L1 errors of the reconstruction in pixel and rFFT space."""
    rec = bilinear(rec, x.shape[1], x.shape[2])
    spatial = (rec - x).abs().mean(dim=(1, 2, 3))
    diff = (spectrum(rec) - spectrum(x)).abs()
    c = diff.shape[-1] // 2
    return rec, spatial, (diff[..., :c] + diff[..., c:]).mean(dim=(1, 2, 3))


class _UniDefense(nn.Module):
    """Encoder -> decoder reconstructing the input -> dual-space attention on
    a mid-level embedding -> the rest -> frozen-bias BatchNorm bottleneck ->
    dropout -> classifier."""

    act = staticmethod(F.silu)

    def head(self, nx, att: int, emb: int, num_classes: int, drop_rate: float,
             feat_drop_rate: float):
        """The attention over ``att`` channels, the bottleneck and the
        classifier over ``emb``."""
        self.drop_rate, self.feat_drop_rate = drop_rate, feat_drop_rate
        self.freq_filter = DynamicFilter(nx, 2 * att, 6, 1, self.act)
        self.spat_filter = DynamicFilter(nx, att, 3, 3, self.act)
        self.fuse_coef = nn.Parameter(torch.empty((), device="meta"))
        self.bottleneck = BatchNorm(nx, emb, frozen_bias=True)
        self.classifier = Classifier(nx, emb, num_classes)

    def attention(self, pred, x, emb, draws):
        eh, ew = emb.shape[2], emb.shape[3]
        pred, x = bilinear(nhwc(pred), eh, ew), bilinear(nhwc(x), eh, ew)
        freq_diff = (spectrum(pred) - spectrum(x)).abs()
        freq_mask, filtered = self.freq_filter(nchw(spectrum(nhwc(emb))), nchw(freq_diff))
        filtered = nchw(inverse_spectrum(nhwc(filtered), (eh, ew)))
        spat_mask, spat = self.spat_filter(emb, nchw((pred - x).abs()))
        coef = torch.sigmoid(self.fuse_coef)
        out = (1.0 - coef) * spat + coef * filtered
        out = out + dropout(emb, self.drop_rate, self.training, draws)
        return out, freq_mask, spat_mask

    def finish(self, emb, triplet, freq_mask, spat_mask, dec_out, x, draws):
        emb = self.bottleneck(self.classifier.nx(emb.mean(dim=(2, 3))))
        factorization = emb
        cls_out = self.classifier(dropout(emb, self.drop_rate, self.training, draws))
        rec, spatial, freq = _recon_losses(nhwc(dec_out), nhwc(x))
        return {"cls_out": cls_out, "rec": nchw(rec),
                "loss_dict": {"factorization": factorization, "triplet": triplet,
                              "freq_mask": freq_mask, "spat_mask": spat_mask,
                              "spatial": spatial, "freq": freq}}


class UDEB4(_UniDefense):
    def __init__(self, nx: Numerics, extractor: str = "efficientnet-b4", num_classes: int = 2,
                 drop_rate: float = 0.2, drop_connect_rate: float = 0.2,
                 feat_drop_rate: float = 0.2, delimiter=None, **_):
        super().__init__()
        self.backbone = EfficientNet(nx, extractor, drop_connect_rate)
        self.delimiter = list(delimiter or DELIMITER[extractor])
        specs, d = self.backbone.specs, self.delimiter
        c_b4, c_b5 = specs[d[4] - 1].cout, specs[d[5] - 1].cout
        self.dec_block1 = DecoderBlock(nx, c_b4, 80)
        self.dec_block2 = DecoderBlock(nx, 80, 40)
        self.dec_block3 = DecoderBlock(nx, 40, 20, final=True)
        self.head(nx, c_b5, self.backbone.head_filters, num_classes, drop_rate, feat_drop_rate)

    def set_recompute(self, on: bool) -> None:
        self.backbone.recompute = on

    def forward(self, x, noise_x=None, draws: Optional[Draws] = None):
        noise_x = x if noise_x is None else noise_x
        bb, d = self.backbone, [0] + self.delimiter
        h = F.silu(bb._bn0(bb._conv_stem(noise_x)))
        feats = []
        for i in range(5):
            h = bb.blocks(h, d[i], d[i + 1], draws)
            feats.append(h)
        x_b4 = feats[4]
        dec1 = self.dec_block1(dropout(x_b4, self.feat_drop_rate, self.training, draws))
        dec2 = self.dec_block2(dec1)
        dec3 = self.dec_block3(dec2)
        x_b5 = bb.blocks(x_b4, d[5], d[6], draws)
        out, fm, sm = self.attention(dec3.detach(), x, x_b5, draws)
        h = bb.blocks(out, d[6], d[7], draws)
        h = F.silu(bb._bn1(bb._conv_head(h)))
        triplet = [x_b4.mean(dim=(2, 3)), dec1.mean(dim=(2, 3)), dec2.mean(dim=(2, 3))]
        return self.finish(h, triplet, fm, sm, dec3, x, draws)


class UDR50(_UniDefense):
    act = staticmethod(F.relu)

    def __init__(self, nx: Numerics, num_classes: int = 2, drop_rate: float = 0.2,
                 feat_drop_rate: float = 0.2, **_):
        super().__init__()
        self.extractor = ExtractorRes50(nx)
        self.emb_block1 = EmbedderRes50Layer1(nx)
        self.emb_block2 = EmbedderRes50Layer2(nx)
        widths = (1024, 256, 128, 64)
        for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
            last = i == len(widths) - 2
            self.add_module(f"dec_block{i + 1}", DecoderBlock(nx, a, b, 32 if last else None,
                                                              final=last, act=F.relu))
        self.head(nx, 2048, 2048, num_classes, drop_rate, feat_drop_rate)

    def set_recompute(self, on: bool) -> None:
        for i in (1, 2, 3):
            getattr(self.extractor, f"layer{i}").recompute = on

    def forward(self, x, noise_x=None, draws: Optional[Draws] = None):
        noise_x = x if noise_x is None else noise_x
        feat = self.extractor(noise_x)
        dec = [dropout(feat, self.feat_drop_rate, self.training, draws)]
        for i in range(3):
            dec.append(getattr(self, f"dec_block{i + 1}")(dec[-1]))
        emb = self.emb_block1(feat)
        out, fm, sm = self.attention(dec[-1].detach(), x, emb, draws)
        emb = self.emb_block2(out)
        triplet = [feat.mean(dim=(2, 3)), dec[1].mean(dim=(2, 3))]
        return self.finish(emb, triplet, fm, sm, dec[-1], x, draws)


MODELS = {"UDEB4": UDEB4, "UDR50": UDR50}


def model_class(name: str):
    """The reference class of a configuration's model: one of ``MODELS``, or
    ``MODEL`` of the module ``perfbench/reference/<name in lower case>.py``
    (a model a later configuration adds)."""
    if name in MODELS:
        return MODELS[name]
    import importlib

    return importlib.import_module(f"perfbench.reference.{name.lower()}").MODEL


def meta(model_cfg: dict, nx: Numerics = None) -> nn.Module:
    """The reference model of ``model_cfg`` on the ``meta`` device."""
    cfg = {k: v for k, v in model_cfg.items() if k != "name"}
    return model_class(model_cfg["name"])(nx or Numerics(), **cfg)


def build(model_cfg: dict, nx: Numerics, state_dict: dict, device) -> nn.Module:
    """The reference model named by ``model_cfg['name']`` with the keys of
    the configuration's ``model:`` section, holding ``state_dict`` (float32)
    on ``device``."""
    model = meta(model_cfg, nx)
    model = model.to_empty(device=device)
    model.load_state_dict({k: v.to(device=device) for k, v in state_dict.items()}, strict=True)
    return model

"""ResNet-18/50 with SFConv substitution, and the UniDefense extractor and
embedder blocks built from them (unidefense_tpu/models/resnet.py).

SFConv replaces a conv only in stages 2-4 and only where its in and out
channels match (``layers.conv_or_sfconv``); the SFConvs use int padding 1,
and pool their frequency branch to a strided output. Module names are the
torchvision/timm keys (``conv1``, ``layerL.B.convK``, ``downsample.0/1``) so
the state dicts of ``models/convert.py`` load strictly. NCHW in and out.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from unidefense_torch.device import nchw, nhwc, optional_dtype
from unidefense_torch.models.layers import BatchNorm, Conv, SFConv, conv_or_sfconv, remat_call
from unidefense_torch.ops.resize import adaptive_avg_pool, max_pool


def _kaiming(*convs: nn.Module) -> None:
    """The reference ResNet's init: kaiming normal, fan out, ReLU gain."""
    for conv in convs:
        nn.init.kaiming_normal_(conv.weight, mode="fan_out", nonlinearity="relu")


def _downsample(in_ch: int, out_ch: int, stride: int, bias: bool = False,
                dtype: Optional[torch.dtype] = None) -> nn.Sequential:
    """The 1x1 conv + BatchNorm shortcut (``downsample.0``, ``downsample.1``)."""
    return nn.Sequential(Conv(in_ch, out_ch, 1, stride, 0, bias=bias, dtype=dtype),
                         BatchNorm(out_ch, dtype=dtype))


def _pool(x: torch.Tensor) -> torch.Tensor:
    """The embedders' max-pool 3/2/1 of the shortcut, NCHW."""
    return nchw(max_pool(nhwc(x), 3, 2, 1))


class BasicBlock(nn.Module):
    """ResNet basic block (resnet.py:30-97), expansion 1. ``bn2``'s scale
    starts at zero."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False, sfconv: bool = False,
                 dtype: Optional[torch.dtype] = None, v4_widths: Iterable[int] = ()):
        super().__init__()
        kw = dict(dtype=dtype, v4_widths=v4_widths)
        self.conv1 = conv_or_sfconv(sfconv and inplanes == planes, inplanes, planes, 3, stride,
                                    1, **kw)
        self.bn1 = BatchNorm(planes, dtype=dtype)
        self.conv2 = conv_or_sfconv(sfconv, planes, planes, 3, 1, 1, **kw)
        self.bn2 = BatchNorm(planes, dtype=dtype)
        nn.init.zeros_(self.bn2.weight)
        self.downsample = _downsample(inplanes, planes, stride, dtype=dtype) \
            if has_downsample else None
        _kaiming(self.conv1, self.conv2, *([self.downsample[0]] if has_downsample else []))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        shortcut = x if self.downsample is None else self.downsample(x)
        return F.relu(y + shortcut)


class Bottleneck(nn.Module):
    """ResNet bottleneck block (resnet.py:100-193), expansion 4; only conv2
    (width to width, carrying the stride) can pass the SFConv gate.
    ``bn3``'s scale starts at zero."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False, sfconv: bool = False,
                 dtype: Optional[torch.dtype] = None, v4_widths: Iterable[int] = ()):
        super().__init__()
        width, outplanes = planes, planes * self.expansion
        kw = dict(dtype=dtype, v4_widths=v4_widths)
        self.conv1 = conv_or_sfconv(sfconv and inplanes == width, inplanes, width, 1, 1, 0, **kw)
        self.bn1 = BatchNorm(width, dtype=dtype)
        self.conv2 = conv_or_sfconv(sfconv, width, width, 3, stride, 1, **kw)
        self.bn2 = BatchNorm(width, dtype=dtype)
        self.conv3 = conv_or_sfconv(sfconv and width == outplanes, width, outplanes, 1, 1, 0,
                                    **kw)
        self.bn3 = BatchNorm(outplanes, dtype=dtype)
        nn.init.zeros_(self.bn3.weight)
        self.downsample = _downsample(inplanes, outplanes, stride, dtype=dtype) \
            if has_downsample else None
        _kaiming(self.conv1, self.conv2, self.conv3,
                 *([self.downsample[0]] if has_downsample else []))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        shortcut = x if self.downsample is None else self.downsample(x)
        return F.relu(y + shortcut)


class ResNetStage(nn.Sequential):
    """One residual stage, blocks ``0..num_blocks-1`` (resnet.py:196-226):
    block 0 takes the stride, and a downsample where the stride is not 1 or
    the channels change. ``remat``: each block rematerialised in training
    (``layers.remat_call``; resnet.py:211-213's ``nn.remat``)."""

    def __init__(self, block_cls: type, inplanes: int, planes: int, num_blocks: int,
                 stride: int, sfconv: bool, dtype: Optional[torch.dtype] = None,
                 v4_widths: Iterable[int] = (), remat: bool = False):
        out = planes * block_cls.expansion
        blocks = []
        for i in range(num_blocks):
            s = stride if i == 0 else 1
            has_down = i == 0 and (s != 1 or inplanes != out)
            blocks.append(block_cls(inplanes, planes, s, has_down, sfconv, dtype, v4_widths))
            inplanes = out
        super().__init__(*blocks)
        self.remat = remat

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self:
            x = remat_call(block, x) if self.remat else block(x)
        return x


ARCH = {"resnet18": (BasicBlock, [2, 2, 2, 2]), "resnet50": (Bottleneck, [3, 4, 6, 3])}
CHANNELS = [64, 128, 256, 512]


class ResNet(nn.Module):
    """ResNet-18/50 with SFConv in stages 2-4 when ``freq_norm`` is set
    (resnet.py:229-274): stem conv 7/2/3 + BN + ReLU, max-pool 3/2/1,
    ``num_stages`` stages (``layer1``...), and with ``include_top`` a global
    average pool and the linear head ``fc`` (N(0, 0.01), as the JAX
    ``Classifier``). ``forward`` returns {'cls_out'}; ``stem`` and
    ``stage(x, i)`` run the parts, for the extractors. ``remat``: every
    stage's blocks rematerialised in training."""

    def __init__(self, arch: str = "resnet18", num_classes: int = 1000,
                 freq_norm: Optional[str] = None, dtype: Optional[torch.dtype] = None,
                 v4_widths: Iterable[int] = (), num_stages: int = 4, include_top: bool = True,
                 remat: bool = False):
        super().__init__()
        if arch not in ARCH:
            raise KeyError(f"ResNet arch '{arch}' not found; available: {sorted(ARCH)}")
        block_cls, layers = ARCH[arch]
        self.compute_dtype = optional_dtype(dtype)
        self.conv1 = Conv(3, 64, 7, 2, 3, bias=False, dtype=dtype)
        self.bn1 = BatchNorm(64, dtype=dtype)
        _kaiming(self.conv1)
        inplanes = 64
        for i in range(num_stages):
            stage = ResNetStage(block_cls, inplanes, CHANNELS[i], layers[i], 1 if i == 0 else 2,
                                freq_norm is not None and i > 0, dtype, v4_widths, remat)
            self.add_module(f"layer{i + 1}", stage)
            inplanes = CHANNELS[i] * block_cls.expansion
        self.num_stages = num_stages
        if include_top:
            self.fc = nn.Linear(inplanes, num_classes)
            nn.init.normal_(self.fc.weight, std=0.01)
            nn.init.zeros_(self.fc.bias)

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn1(self.conv1(x)))

    def stage(self, x: torch.Tensor, i: int) -> torch.Tensor:
        return getattr(self, f"layer{i + 1}")(x)

    def forward(self, x: torch.Tensor) -> dict:
        x = _pool(self.stem(x))
        for i in range(self.num_stages):
            x = self.stage(x, i)
        dt = self.compute_dtype
        x = x.mean(dim=(2, 3)).to(dt)
        return {"cls_out": F.linear(x, self.fc.weight.to(dt), self.fc.bias.to(dt))}


class ExtractorRes18(ResNet):
    """ResNet-18 stem (no max-pool) and layers 1-3 (resnet.py:277-304).
    Returns (layer3, cat[layer1, layer2 pooled to layer3's size, layer3]):
    64 + 128 + 256 = 448 channels. The JAX extractor never calls layer4 or
    the head, so neither is registered."""

    def __init__(self, freq_norm: Optional[str] = "ortho", dtype: Optional[torch.dtype] = None,
                 v4_widths: Iterable[int] = (), remat: bool = False):
        super().__init__("resnet18", freq_norm=freq_norm, dtype=dtype, v4_widths=v4_widths,
                         num_stages=3, include_top=False, remat=remat)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        p1 = self.stage(self.stem(x), 0)
        p2 = self.stage(p1, 1)
        p3 = self.stage(p2, 2)
        h, w = p3.shape[2], p3.shape[3]
        ds1 = nchw(adaptive_avg_pool(nhwc(p1), h, w))
        ds2 = nchw(adaptive_avg_pool(nhwc(p2), h, w))
        return p3, torch.cat([ds1, ds2, p3], dim=1)


class ExtractorRes50(ResNet):
    """ResNet-50 stem, max-pool and layers 1-3: 1024 channels
    (resnet.py:307-330); no layer4 and no head, as in the JAX extractor."""

    def __init__(self, freq_norm: Optional[str] = "ortho", dtype: Optional[torch.dtype] = None,
                 v4_widths: Iterable[int] = (), remat: bool = False):
        super().__init__("resnet50", freq_norm=freq_norm, dtype=dtype, v4_widths=v4_widths,
                         num_stages=3, include_top=False, remat=remat)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _pool(self.stem(x))
        for i in range(3):
            x = self.stage(x, i)
        return x


class EmbedderRes18Layer1(nn.Module):
    """448 -> 512, stride 2: conv 3/2 + BN + ReLU, SFConv + BN, and a 1x1
    conv + BN + max-pool 3/2/1 shortcut (resnet.py:333-358)."""

    def __init__(self, in_ch: int = 448, bias: bool = False,
                 dtype: Optional[torch.dtype] = None, v4_widths: Iterable[int] = ()):
        super().__init__()
        self.conv1 = Conv(in_ch, 512, 3, 2, 1, bias=bias, dtype=dtype)
        self.norm1 = BatchNorm(512, dtype=dtype)
        self.conv2 = SFConv(512, 3, 1, 1, bias=bias, dtype=dtype, v4_widths=v4_widths)
        self.norm2 = BatchNorm(512, dtype=dtype)
        self.downsample = _downsample(in_ch, 512, 1, bias, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = self.norm2(self.conv2(y))
        return F.relu(y + _pool(self.downsample(x)))


class EmbedderRes18Layer2(nn.Module):
    """512 -> 512: SFConv + BN + ReLU, conv + BN, identity shortcut
    (resnet.py:361-379)."""

    def __init__(self, bias: bool = False, dtype: Optional[torch.dtype] = None,
                 v4_widths: Iterable[int] = ()):
        super().__init__()
        self.conv1 = SFConv(512, 3, 1, 1, bias=bias, dtype=dtype, v4_widths=v4_widths)
        self.norm1 = BatchNorm(512, dtype=dtype)
        self.conv2 = Conv(512, 512, 3, 1, 1, bias=bias, dtype=dtype)
        self.norm2 = BatchNorm(512, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        return F.relu(self.norm2(self.conv2(y)) + x)


class EmbedderRes50Layer1(nn.Module):
    """1024 -> 2048, stride 2: 1x1 conv, SFConv 3/2, 1x1 conv, each with a
    BN, and a 1x1 conv + BN + max-pool 3/2/1 shortcut (resnet.py:382-411)."""

    def __init__(self, in_ch: int = 1024, bias: bool = False,
                 dtype: Optional[torch.dtype] = None, v4_widths: Iterable[int] = ()):
        super().__init__()
        self.conv1 = Conv(in_ch, 512, 1, 1, 0, bias=bias, dtype=dtype)
        self.norm1 = BatchNorm(512, dtype=dtype)
        self.conv2 = SFConv(512, 3, 2, 1, bias=bias, dtype=dtype, v4_widths=v4_widths)
        self.norm2 = BatchNorm(512, dtype=dtype)
        self.conv3 = Conv(512, 2048, 1, 1, 0, bias=bias, dtype=dtype)
        self.norm3 = BatchNorm(2048, dtype=dtype)
        self.downsample = _downsample(in_ch, 2048, 1, bias, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        y = self.norm3(self.conv3(y))
        return F.relu(y + _pool(self.downsample(x)))


class EmbedderRes50Layer2(nn.Module):
    """2048 -> 2048: 1x1 conv, SFConv 3/1, 1x1 conv, each with a BN, and an
    identity shortcut (resnet.py:414-437)."""

    def __init__(self, bias: bool = False, dtype: Optional[torch.dtype] = None,
                 v4_widths: Iterable[int] = ()):
        super().__init__()
        self.conv1 = Conv(2048, 512, 1, 1, 0, bias=bias, dtype=dtype)
        self.norm1 = BatchNorm(512, dtype=dtype)
        self.conv2 = SFConv(512, 3, 1, 1, bias=bias, dtype=dtype, v4_widths=v4_widths)
        self.norm2 = BatchNorm(512, dtype=dtype)
        self.conv3 = Conv(512, 2048, 1, 1, 0, bias=bias, dtype=dtype)
        self.norm3 = BatchNorm(2048, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        return F.relu(self.norm3(self.conv3(y)) + x)

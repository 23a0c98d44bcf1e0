"""EfficientNet (b0-b8) with SFConv depthwise substitution
(unidefense_tpu/models/efficientnet.py:33-133,136-269).

Compound scaling, TF-SAME padding, SE, BN eps 1e-3 and momentum 0.01,
drop-connect in training, and SFConv in every block group except the first
two and the last. Module names are the lukemelas torch keys (``_conv_stem``,
``_blocks.N._expand_conv``, …) so reference state dicts load as they are.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from unidefense_torch.models.layers import BatchNorm, Conv, SFConv, remat_call, uniform

# width, depth, resolution, dropout
PARAMS = {
    "efficientnet-b0": (1.0, 1.0, 224, 0.2),
    "efficientnet-b1": (1.0, 1.1, 240, 0.2),
    "efficientnet-b2": (1.1, 1.2, 260, 0.3),
    "efficientnet-b3": (1.2, 1.4, 300, 0.3),
    "efficientnet-b4": (1.4, 1.8, 380, 0.4),
    "efficientnet-b5": (1.6, 2.2, 456, 0.4),
    "efficientnet-b6": (1.8, 2.6, 528, 0.5),
    "efficientnet-b7": (2.0, 3.1, 600, 0.5),
    "efficientnet-b8": (2.2, 3.6, 672, 0.5),
    "efficientnet-l2": (4.3, 5.3, 800, 0.5),
}

# b0 block-args groups: (num_repeat, kernel, stride, expand, in, out, se_ratio)
B0_BLOCKS = [
    (1, 3, 1, 1, 32, 16, 0.25),
    (2, 3, 2, 6, 16, 24, 0.25),
    (2, 5, 2, 6, 24, 40, 0.25),
    (3, 3, 2, 6, 40, 80, 0.25),
    (3, 5, 1, 6, 80, 112, 0.25),
    (4, 5, 2, 6, 112, 192, 0.25),
    (1, 3, 1, 6, 192, 320, 0.25),
]

BN_EPS = 1e-3
BN_MOMENTUM = 0.01  # torch convention: 1 - 0.99


def get_image_size(model_name: str) -> int:
    """Native input resolution of a variant (model.py:401-413)."""
    return PARAMS[model_name][2]


def round_filters(filters: int, width_coefficient: float, divisor: int = 8) -> int:
    if not width_coefficient:
        return filters
    filters *= width_coefficient
    new_filters = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_filters < 0.9 * filters:
        new_filters += divisor
    return int(new_filters)


def round_repeats(repeats: int, depth_coefficient: float) -> int:
    if not depth_coefficient:
        return repeats
    return int(math.ceil(depth_coefficient * repeats))


@dataclass(frozen=True)
class BlockSpec:
    kernel_size: int
    stride: int
    expand_ratio: int
    input_filters: int
    output_filters: int
    se_ratio: float
    id_skip: bool
    freq_norm: Optional[str]


def build_block_specs(model_name: str, freq_norm: Optional[str]) -> list[BlockSpec]:
    """Per-block specs; groups 0, 1 and the last get plain depthwise convs
    (freq_norm None), the others SFConv."""
    w, d, _, _ = PARAMS[model_name]
    specs = []
    num_groups = len(B0_BLOCKS)
    for group_id, (r, k, s, e, i, o, se) in enumerate(B0_BLOCKS):
        fin = round_filters(i, w)
        fout = round_filters(o, w)
        fn = freq_norm if group_id not in (0, 1, num_groups - 1) else None
        for rep in range(round_repeats(r, d)):
            specs.append(BlockSpec(
                kernel_size=k, stride=s if rep == 0 else 1, expand_ratio=e,
                input_filters=fin if rep == 0 else fout, output_filters=fout,
                se_ratio=se, id_skip=True, freq_norm=fn,
            ))
    return specs


def _bn(features: int, dtype) -> BatchNorm:
    return BatchNorm(features, eps=BN_EPS, momentum=BN_MOMENTUM, dtype=dtype)


def drop_connect(x: torch.Tensor, rate: float,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Stochastic depth: keep each sample's residual branch with probability
    1 - rate, scaled by 1/(1 - rate); one mask value per sample."""
    keep_prob = 1.0 - rate
    mask = torch.floor(keep_prob + uniform((x.shape[0], 1, 1, 1), generator, x.device))
    return x / keep_prob * mask.to(x.dtype)


class MBConvBlock(nn.Module):
    """Mobile inverted residual bottleneck with SE."""

    def __init__(self, spec: BlockSpec, dtype: Optional[torch.dtype] = None,
                 v4_widths: Iterable[int] = ()):
        super().__init__()
        self.spec = spec
        inp = spec.input_filters
        oup = inp * spec.expand_ratio
        if spec.expand_ratio != 1:
            self._expand_conv = Conv(inp, oup, 1, 1, "SAME", bias=False, dtype=dtype)
            self._bn0 = _bn(oup, dtype)
        k, s = spec.kernel_size, spec.stride
        if spec.freq_norm is not None:
            self._depthwise_conv = SFConv(oup, k, s, "SAME", groups=oup, bias=False, dtype=dtype,
                                          v4_widths=v4_widths)
        else:
            self._depthwise_conv = Conv(oup, oup, k, s, "SAME", groups=oup, bias=False,
                                        dtype=dtype)
        self._bn1 = _bn(oup, dtype)
        self.has_se = bool(spec.se_ratio) and 0 < spec.se_ratio <= 1
        if self.has_se:
            num_sq = max(1, int(inp * spec.se_ratio))
            self._se_reduce = Conv(oup, num_sq, 1, 1, "SAME", bias=True, dtype=dtype)
            self._se_expand = Conv(num_sq, oup, 1, 1, "SAME", bias=True, dtype=dtype)
        self._project_conv = Conv(oup, spec.output_filters, 1, 1, "SAME", bias=False, dtype=dtype)
        self._bn2 = _bn(spec.output_filters, dtype)

    def forward(self, x: torch.Tensor, drop_connect_rate: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        spec = self.spec
        inputs = x
        if spec.expand_ratio != 1:
            x = F.silu(self._bn0(self._expand_conv(x)))
        x = F.silu(self._bn1(self._depthwise_conv(x)))
        if self.has_se:
            sq = x.mean(dim=(2, 3), keepdim=True)
            sq = self._se_expand(F.silu(self._se_reduce(sq)))
            x = torch.sigmoid(sq) * x
        x = self._bn2(self._project_conv(x))
        if spec.id_skip and spec.stride == 1 and spec.input_filters == spec.output_filters:
            if self.training and drop_connect_rate:
                x = drop_connect(x, drop_connect_rate, generator)
            x = x + inputs
        return x


class EfficientNet(nn.Module):
    """Backbone without the top, with per-block access so wrappers can run
    delimiter-bounded block ranges. ``v4_widths``: the SFConv widths routed
    to K3 (see ``layers.SFConv``). ``remat``: each MBConv block
    rematerialised in training (``layers.remat_call``; efficientnet.py:
    229-231's ``nn.remat``)."""

    def __init__(self, model_name: str = "efficientnet-b4", freq_norm: Optional[str] = "ortho",
                 drop_connect_rate: float = 0.2, dtype: Optional[torch.dtype] = None,
                 v4_widths: Iterable[int] = (), remat: bool = False):
        super().__init__()
        w = PARAMS[model_name][0]
        self.drop_connect_rate = drop_connect_rate
        self.remat = remat
        self.specs = build_block_specs(model_name, freq_norm)
        stem = round_filters(32, w)
        self.head_filters = round_filters(1280, w)
        self._conv_stem = Conv(3, stem, 3, 2, "SAME", bias=False, dtype=dtype)
        self._bn0 = _bn(stem, dtype)
        self._blocks = nn.ModuleList(MBConvBlock(s, dtype, v4_widths) for s in self.specs)
        self._conv_head = Conv(self.specs[-1].output_filters, self.head_filters, 1, 1, "SAME",
                               bias=False, dtype=dtype)
        self._bn1 = _bn(self.head_filters, dtype)

    def stem_forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self._bn0(self._conv_stem(x)))

    def block_range_forward(self, x: torch.Tensor, start: int, end: int,
                            generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Blocks [start, end); in training block idx drops its residual
        branch at drop_connect_rate * idx / len(blocks)."""
        for idx in range(start, end):
            rate = self.drop_connect_rate * float(idx) / len(self._blocks)
            block = self._blocks[idx]
            x = remat_call(block, x, rate, generator) if self.remat else block(x, rate, generator)
        return x

    def head_forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self._bn1(self._conv_head(x)))

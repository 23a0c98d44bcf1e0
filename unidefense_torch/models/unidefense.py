"""The UniDefense dual-space models: UDEB4 with EfficientNet, UDR18 and
UDR50 with ResNet extractors (unidefense_tpu/models/unidefense.py:51-369).

Encoder -> spatial decoder reconstructing the input -> dual-space attention
re-weighting of a mid-level embedding -> remaining blocks -> frozen-bias BN
bottleneck -> linear classifier; the reconstruction losses (pixel and rFFT
space) are computed in the forward pass. Tensors are NCHW in channels_last;
``rec`` and the masks come back NCHW.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from unidefense_torch.device import nchw, nhwc
from unidefense_torch.models.efficientnet import EfficientNet
from unidefense_torch.models.filters import DynamicFilter, dual_space_attention
from unidefense_torch.models.layers import (
    BatchNorm, Classifier, Conv, ConvTranspose, InstanceNorm, dropout)
from unidefense_torch.models.resnet import (
    EmbedderRes18Layer1, EmbedderRes18Layer2, EmbedderRes50Layer1, EmbedderRes50Layer2,
    ExtractorRes18, ExtractorRes50)
from unidefense_torch.ops.fft import spectrum_channels
from unidefense_torch.ops.resize import bilinear_resize

# EfficientNet-b4 block delimiters (reference model/unidefense.py:22-24)
DELIMITER_DICT = {"efficientnet-b4": [2, 6, 10, 16, 22, 30, 32]}


class _Act(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


class DecoderBlock(nn.Sequential):
    """conv3x3 -> IN -> act -> convT(x2) -> IN -> act -> conv3x3 -> IN -> act
    [-> conv3x3 -> tanh if final]; indices 0-10 as in the reference's
    nn.Sequential decoders."""

    def __init__(self, in_ch: int, features: int, out_features: Optional[int] = None,
                 final: bool = False, use_swish: bool = False, bias: bool = False,
                 affine: bool = True, dtype: Optional[torch.dtype] = None):
        act = F.silu if use_swish else F.relu
        out_f = out_features or features
        layers = [
            Conv(in_ch, features, 3, 1, 1, bias=bias, dtype=dtype),
            InstanceNorm(features, affine=affine, dtype=dtype), _Act(act),
            ConvTranspose(features, features, 3, 2, 1, 1, bias=bias, dtype=dtype),
            InstanceNorm(features, affine=affine, dtype=dtype), _Act(act),
            Conv(features, out_f, 3, 1, 1, bias=bias, dtype=dtype),
            InstanceNorm(out_f, affine=affine, dtype=dtype), _Act(act),
        ]
        if final:
            layers += [Conv(out_f, 3, 3, 1, 1, bias=bias, dtype=dtype), _Act(torch.tanh)]
        super().__init__(*layers)


def _recon_losses(rec: torch.Tensor, x: torch.Tensor, freq_norm: str):
    """Per-sample L1 reconstruction error in pixel and rFFT space; NHWC in,
    rec resized to x's resolution first."""
    rec = bilinear_resize(rec, x.shape[1], x.shape[2])
    spatial = (rec.float() - x.float()).abs().mean(dim=(1, 2, 3))
    diff = (spectrum_channels(rec, freq_norm) - spectrum_channels(x, freq_norm)).abs()
    c = diff.shape[-1] // 2
    freq = (diff[..., :c] + diff[..., c:]).mean(dim=(1, 2, 3))
    return rec, spatial, freq


class UniDefenseModelEb4(nn.Module):
    """UniDefense with an EfficientNet backbone.
    ``forward(x, noise_x=None, generator=None)`` returns {'cls_out', 'rec',
    'loss_dict'} with loss_dict = {factorization, triplet (list of 3),
    freq_mask, spat_mask, spatial, freq}. ``noise_x`` (the perturbed input
    of training pass 2) feeds the backbone; the reconstruction and the
    attention compare against the clean ``x``. In training, drop-connect,
    the decoder-input dropout (``feat_drop_rate``), the attention's
    embedding dropout and the dropout after the bottleneck (``drop_rate``)
    draw their masks from ``generator``; with all rates 0 the forward is
    deterministic. ``v4_widths``: the SFConv widths routed to K3 (see
    ``layers.SFConv``; default none). ``remat``: each backbone block
    rematerialised in training."""

    def __init__(self, extractor: str = "efficientnet-b4", num_classes: int = 2,
                 drop_rate: float = 0.2, drop_connect_rate: float = 0.2,
                 feat_drop_rate: float = 0.2, use_bias: bool = False, affine: bool = True,
                 delimiter: Optional[Sequence[int]] = None, freq_norm: str = "ortho",
                 dtype: Optional[torch.dtype] = None, v4_widths: Iterable[int] = (),
                 remat: bool = False):
        super().__init__()
        self.freq_norm = freq_norm
        self.compute_dtype = dtype
        self.drop_rate = drop_rate
        self.feat_drop_rate = feat_drop_rate
        self.backbone = EfficientNet(extractor, freq_norm, drop_connect_rate, dtype, v4_widths,
                                     remat)
        self.delimiter = list(delimiter or DELIMITER_DICT[extractor])
        specs = self.backbone.specs
        d = self.delimiter
        c_b4 = specs[d[4] - 1].output_filters   # decoder input
        c_b5 = specs[d[5] - 1].output_filters   # attention embedding
        kw = dict(bias=use_bias, affine=affine, use_swish=True, dtype=dtype)
        self.dec_block1 = DecoderBlock(c_b4, 80, **kw)
        self.dec_block2 = DecoderBlock(80, 40, **kw)
        self.dec_block3 = DecoderBlock(40, 20, final=True, **kw)
        self.freq_filter = DynamicFilter(2 * c_b5, 6, 1, F.silu, use_bias, dtype)
        self.spat_filter = DynamicFilter(c_b5, 3, 3, F.silu, use_bias, dtype)
        self.fuse_coef = nn.Parameter(torch.tensor(0.0))
        self.bottleneck = BatchNorm(self.backbone.head_filters, frozen_bias=True, dtype=dtype)
        self.classifier = Classifier(self.backbone.head_filters, num_classes, dtype)

    def _block(self, x: torch.Tensor, block_id: int,
               generator: Optional[torch.Generator]) -> torch.Tensor:
        start = self.delimiter[block_id - 1] if block_id > 0 else 0
        return self.backbone.block_range_forward(x, start, self.delimiter[block_id], generator)

    def forward(self, x: torch.Tensor, noise_x: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> dict:
        if noise_x is None:
            noise_x = x
        g = generator
        h = self.backbone.stem_forward(noise_x)
        x_b0 = self._block(h, 0, g)
        x_b1 = self._block(x_b0, 1, g)
        x_b2 = self._block(x_b1, 2, g)
        x_b3 = self._block(x_b2, 3, g)
        x_b4 = self._block(x_b3, 4, g)

        dec_in = dropout(x_b4, self.feat_drop_rate, self.training, g)
        dec_out1 = self.dec_block1(dec_in)
        dec_out2 = self.dec_block2(dec_out1)
        dec_out3 = self.dec_block3(dec_out2)

        x_b5 = self._block(x_b4, 5, g)
        att = dual_space_attention(self.freq_filter, self.spat_filter, self.fuse_coef,
                                   dec_out3.detach(), x, x_b5, self.freq_norm,
                                   self.compute_dtype, self.drop_rate, self.training, g)
        x_out = self._block(att["out"], 6, g)
        x_out = self.backbone.head_forward(x_out)
        x_out = self.bottleneck(x_out.mean(dim=(2, 3)))
        factorization = x_out
        x_out = dropout(x_out, self.drop_rate, self.training, g)

        loss_dict = {
            "factorization": factorization,
            "triplet": [x_b4.mean(dim=(2, 3)), dec_out1.mean(dim=(2, 3)),
                        dec_out2.mean(dim=(2, 3))],
            "freq_mask": att["freq_mask"],
            "spat_mask": att["spat_mask"],
        }
        cls_out = self.classifier(x_out)
        rec, spatial, freq = _recon_losses(nhwc(dec_out3), nhwc(x), self.freq_norm)
        loss_dict["spatial"] = spatial
        loss_dict["freq"] = freq
        return {"cls_out": cls_out, "rec": nchw(rec), "loss_dict": loss_dict}


class _UniDefenseResNet(nn.Module):
    """The part UDR18 and UDR50 share (unidefense.py:211-369): ResNet
    extractor -> ReLU decoders on the (dropped-out) extractor features;
    embedder layer 1 -> dual-space attention (ReLU filters) -> embedder
    layer 2 -> global pool -> frozen-bias BN bottleneck -> dropout ->
    classifier. ``triplet`` holds the pooled extractor features and the
    first decoder's output. Same ``forward`` contract as
    :class:`UniDefenseModelEb4`. ``extractor`` and ``mid_depth`` are the
    JAX fields; each must name what the subclass builds. ``remat``: each
    block of the extractor's stages rematerialised in training (the JAX
    models remat the extractor's ``ResNetStage``s, not the embedders)."""

    ARCH: str
    MID_DEPTH: int  # extractor channels, the decoder's input
    EMB_DEPTH: int  # embedding channels
    DEC_FEATURES: tuple  # decoder widths; the last decoder narrows to 32 and adds the head

    def __init__(self, extractor: str, mid_depth: int, num_classes: int, drop_rate: float,
                 feat_drop_rate: float, use_bias: bool, affine: bool, freq_norm: str,
                 dtype: Optional[torch.dtype], v4_widths: Iterable[int], remat: bool = False):
        super().__init__()
        name = type(self).__name__
        if extractor != self.ARCH:
            raise ValueError(f"{name} takes extractor '{self.ARCH}', not '{extractor}'")
        if mid_depth != self.MID_DEPTH:
            raise ValueError(f"{name}: the {self.ARCH} extractor gives {self.MID_DEPTH} "
                             f"channels, not mid_depth {mid_depth}")
        self.freq_norm = freq_norm
        self.compute_dtype = dtype
        self.drop_rate = drop_rate
        self.feat_drop_rate = feat_drop_rate
        self.build_blocks(freq_norm, use_bias, dtype, v4_widths, remat)
        kw = dict(bias=use_bias, affine=affine, use_swish=False, dtype=dtype)
        widths = (mid_depth, *self.DEC_FEATURES)
        for i, (c_in, c_out) in enumerate(zip(widths[:-1], widths[1:])):
            last = i == len(self.DEC_FEATURES) - 1
            block = DecoderBlock(c_in, c_out, 32 if last else None, final=last, **kw)
            self.add_module(f"dec_block{i + 1}", block)
        emb = self.EMB_DEPTH
        self.freq_filter = DynamicFilter(2 * emb, 6, 1, F.relu, use_bias, dtype)
        self.spat_filter = DynamicFilter(emb, 3, 3, F.relu, use_bias, dtype)
        self.fuse_coef = nn.Parameter(torch.tensor(0.0))
        self.bottleneck = BatchNorm(emb, frozen_bias=True, dtype=dtype)
        self.classifier = Classifier(emb, num_classes, dtype)

    def build_blocks(self, freq_norm, use_bias, dtype, v4_widths, remat) -> None:
        """Register ``extractor``, ``emb_block1`` and ``emb_block2``."""
        raise NotImplementedError

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The extractor features the decoders and the embedders take."""
        return self.extractor(x)

    def forward(self, x: torch.Tensor, noise_x: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> dict:
        if noise_x is None:
            noise_x = x
        g = generator
        ext_feat = self.features(noise_x)
        dec = [dropout(ext_feat, self.feat_drop_rate, self.training, g)]
        for i in range(len(self.DEC_FEATURES)):
            dec.append(getattr(self, f"dec_block{i + 1}")(dec[-1]))

        emb = self.emb_block1(ext_feat)
        att = dual_space_attention(self.freq_filter, self.spat_filter, self.fuse_coef,
                                   dec[-1].detach(), x, emb, self.freq_norm, self.compute_dtype,
                                   self.drop_rate, self.training, g)
        emb = self.emb_block2(att["out"])
        emb = self.bottleneck(emb.mean(dim=(2, 3)))
        factorization = emb
        emb = dropout(emb, self.drop_rate, self.training, g)

        loss_dict = {
            "factorization": factorization,
            "triplet": [ext_feat.mean(dim=(2, 3)), dec[1].mean(dim=(2, 3))],
            "freq_mask": att["freq_mask"],
            "spat_mask": att["spat_mask"],
        }
        cls_out = self.classifier(emb)
        rec, spatial, freq = _recon_losses(nhwc(dec[-1]), nhwc(x), self.freq_norm)
        loss_dict["spatial"] = spatial
        loss_dict["freq"] = freq
        return {"cls_out": cls_out, "rec": nchw(rec), "loss_dict": loss_dict}


class UniDefenseModelRes18(_UniDefenseResNet):
    """UniDefense with the ResNet-18 multi-scale extractor
    (unidefense.py:211-288): 448 extractor channels, decoders 448 -> 128 ->
    64/32 -> 3, a 512-channel embedding. ``v4_widths``: the SFConv widths
    routed to K3 (see ``layers.SFConv``; default none)."""

    ARCH, MID_DEPTH, EMB_DEPTH, DEC_FEATURES = "resnet18", 448, 512, (128, 64)

    def __init__(self, extractor: str = "resnet18", mid_depth: int = 448, num_classes: int = 2,
                 drop_rate: float = 0.2, feat_drop_rate: float = 0.2, use_bias: bool = False,
                 affine: bool = True, freq_norm: str = "ortho",
                 dtype: Optional[torch.dtype] = None, v4_widths: Iterable[int] = (),
                 remat: bool = False):
        super().__init__(extractor, mid_depth, num_classes, drop_rate, feat_drop_rate, use_bias,
                         affine, freq_norm, dtype, v4_widths, remat)

    def build_blocks(self, freq_norm, use_bias, dtype, v4_widths, remat) -> None:
        kw = dict(dtype=dtype, v4_widths=v4_widths)
        self.extractor = ExtractorRes18(freq_norm, remat=remat, **kw)
        self.emb_block1 = EmbedderRes18Layer1(self.MID_DEPTH, use_bias, **kw)
        self.emb_block2 = EmbedderRes18Layer2(use_bias, **kw)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        return self.extractor(x)[1]


class UniDefenseModelRes50(_UniDefenseResNet):
    """UniDefense with the ResNet-50 extractor (unidefense.py:291-369): 1024
    extractor channels, decoders 1024 -> 256 -> 128 -> 64/32 -> 3, a
    2048-channel embedding. ``v4_widths``: as for UDR18."""

    ARCH, MID_DEPTH, EMB_DEPTH, DEC_FEATURES = "resnet50", 1024, 2048, (256, 128, 64)

    def __init__(self, extractor: str = "resnet50", mid_depth: int = 1024, num_classes: int = 2,
                 drop_rate: float = 0.2, feat_drop_rate: float = 0.2, use_bias: bool = False,
                 affine: bool = True, freq_norm: str = "ortho",
                 dtype: Optional[torch.dtype] = None, v4_widths: Iterable[int] = (),
                 remat: bool = False):
        super().__init__(extractor, mid_depth, num_classes, drop_rate, feat_drop_rate, use_bias,
                         affine, freq_norm, dtype, v4_widths, remat)

    def build_blocks(self, freq_norm, use_bias, dtype, v4_widths, remat) -> None:
        kw = dict(dtype=dtype, v4_widths=v4_widths)
        self.extractor = ExtractorRes50(freq_norm, remat=remat, **kw)
        self.emb_block1 = EmbedderRes50Layer1(self.MID_DEPTH, use_bias, **kw)
        self.emb_block2 = EmbedderRes50Layer2(use_bias, **kw)

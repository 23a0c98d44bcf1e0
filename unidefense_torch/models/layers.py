"""Shared building blocks (unidefense_tpu/models/layers.py).

Modules take and return NCHW tensors (kept in ``channels_last`` memory
format by the models). Parameters are fp32; each layer casts to its compute
``dtype`` where the JAX layer does: convs cast input and weight, the norms
compute in fp32 and cast back, the SFConv frequency branch is cast to fp32
before pooling. Parameter names follow the reference's torch modules so the
state dicts of ``models/convert.py`` load strictly.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Iterable, Optional, Union

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from unidefense_torch.device import nchw, nhwc, optional_dtype
from unidefense_torch.ops.resize import adaptive_avg_pool
from unidefense_torch.ops.sfconv_cuda import sfconv_freq
from unidefense_torch.ops.sfconv_rowtiled import sfconv_freq_v4, uses_v4
from unidefense_torch.parallel.mesh import all_reduce_sum, batch_draw

Padding = Union[str, int]

_recompute = threading.local()  # .on: this thread is recomputing a remat block


def recomputing() -> bool:
    """True inside :func:`remat_call`'s recompute (in the backward pass)."""
    return getattr(_recompute, "on", False)


@contextlib.contextmanager
def _recompute_context():
    before = recomputing()
    _recompute.on = True
    try:
        yield
    finally:
        _recompute.on = before


def _remat_contexts():
    return contextlib.nullcontext(), _recompute_context()


def _replayed(generator: torch.Generator, state: torch.Tensor) -> torch.Generator:
    clone = type(generator)(device=generator.device)
    clone.set_state(state)
    if hasattr(generator, "rows"):  # parallel.mesh.BatchRows
        clone.rows = generator.rows
    return clone


def remat_call(block: nn.Module, x: torch.Tensor, *args):
    """``block(x, *args)``, rematerialised (``nn.remat`` in JAX): in
    training with grad enabled the block keeps no activations and runs its
    forward again in the backward pass (``torch.utils.checkpoint``,
    non-reentrant); otherwise it is a plain call. The recompute changes
    nothing the forward left behind: BatchNorm normalises with the
    recomputed batch statistics without moving its running statistics
    again (flax discards the recompute's ``batch_stats``), and a
    ``torch.Generator`` among ``args`` is replayed from the state it had
    before the block on a clone, so the recompute draws the forward's
    masks and the caller's generator advances once."""
    if not (block.training and torch.is_grad_enabled()):
        return block(x, *args)
    from torch.utils.checkpoint import checkpoint

    states = [a.get_state() if isinstance(a, torch.Generator) else None for a in args]

    def run(x):
        call = args
        if recomputing():
            call = tuple(a if s is None else _replayed(a, s) for a, s in zip(args, states))
        return block(x, *call)

    return checkpoint(run, x, use_reentrant=False, context_fn=_remat_contexts)


def same_pad(x: torch.Tensor, kernel_size: int, stride: int) -> torch.Tensor:
    """TF-static SAME padding (XLA 'SAME'): pad_total = max((ceil(i/s)-1)*s +
    k - i, 0), low half = pad_total // 2, the rest high."""
    pads = []
    for size in (x.shape[3], x.shape[2]):  # F.pad order: W first, then H
        total = max((math.ceil(size / stride) - 1) * stride + kernel_size - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


class Conv(nn.Conv2d):
    """Conv2d with ``padding='SAME'`` (TF static) or int symmetric padding,
    computing in ``dtype`` (layers.py:45-75)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 padding: Padding = 0, groups: int = 1, bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        self.same = padding == "SAME"
        super().__init__(in_ch, out_ch, kernel_size, stride,
                         padding=0 if self.same else padding, groups=groups, bias=bias)
        self.compute_dtype = optional_dtype(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.same:
            x = same_pad(x, self.kernel_size[0], self.stride[0])
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride, self.padding,
                        groups=self.groups)


class BatchNorm(nn.Module):
    """BatchNorm with torch semantics, computed in fp32 and cast to ``dtype``
    (layers.py:78-137). Works on (N, C) and (N, C, H, W).

    Training normalises with the biased batch variance and moves the running
    statistics by ``momentum`` (torch convention: new = (1-m)*old + m*batch),
    the running variance with the unbiased estimate. ``frozen_bias`` keeps a
    zero bias that is not trained, as the reference's bottleneck does.

    ``group`` (set by ``parallel.sync_batchnorm``) syncs the training
    statistics over the ranks, as ``axis_name`` does in JAX (layers.py:
    116-134): the per-rank E[x] and E[x^2] are summed over the ranks in fp32
    (a sum whose gradient is summed over the ranks too) and divided by the
    world size, n counts every rank's frames, and var = max(E[x^2] -
    E[x]^2, 0). Without a group the statistics are this process's own.

    The recompute of a rematerialised block (:func:`remat_call`) normalises
    as the forward did and leaves the running statistics and
    ``num_batches_tracked`` alone."""

    group = None  # a torch.distributed process group, or None

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.1,
                 frozen_bias: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features), requires_grad=not frozen_bias)
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xf = x.float()
        if self.training:
            dims = (0,) + tuple(range(2, x.dim()))
            n = xf.numel() // xf.shape[1]
            if self.group is None:
                var, mean = torch.var_mean(xf, dim=dims, correction=0)
            else:
                world = dist.get_world_size(self.group)
                moments = torch.stack([xf.mean(dim=dims), (xf * xf).mean(dim=dims)])
                mean, mean2 = all_reduce_sum(moments, self.group) / world
                var = torch.clamp(mean2 - mean * mean, min=0.0)
                n *= world
            if not recomputing():
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.mul_(1 - m).add_(m * mean)
                    self.running_var.mul_(1 - m).add_(m * n / max(n - 1, 1) * var)
                    self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        scale = (self.weight * torch.rsqrt(var + self.eps)).view(shape)
        y = (xf - mean.view(shape)) * scale + self.bias.view(shape)
        return y.to(self.compute_dtype or x.dtype)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability 1 - rate and
    scale it by 1/(1 - rate). The mask is drawn from ``generator`` (on its
    device; F.dropout cannot take one), or from the global generator of x's
    device when it is None."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = uniform(x.shape, generator, x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def uniform(shape, generator: Optional[torch.Generator], device: torch.device) -> torch.Tensor:
    """U[0, 1) of the batch-leading ``shape`` on ``device``, drawn on the
    generator's device (at the global batch's rows for a
    ``parallel.mesh.BatchRows`` generator)."""
    if generator is None:
        return torch.rand(shape, device=device)
    return batch_draw(torch.rand, shape, generator).to(device)


class InstanceNorm(nn.Module):
    """nn.InstanceNorm2d(affine=True) semantics in fp32: biased variance,
    eps 1e-5 (layers.py:140-159)."""

    def __init__(self, features: int, eps: float = 1e-5, affine: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps = eps
        self.compute_dtype = dtype
        if affine:
            self.weight = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.weight = self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var, mean = torch.var_mean(xf, dim=(2, 3), keepdim=True, correction=0)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        if self.weight is not None:
            y = y * self.weight.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)
        return y.to(self.compute_dtype or x.dtype)


class Classifier(nn.Module):
    """Linear head, N(0, 0.01) weights and zero bias (layers.py:162-176)."""

    def __init__(self, in_features: int, num_classes: int = 2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.fc = nn.Linear(in_features, num_classes)
        nn.init.normal_(self.fc.weight, std=0.01)
        nn.init.zeros_(self.fc.bias)
        self.compute_dtype = optional_dtype(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.fc.weight.to(dt), self.fc.bias.to(dt))


class SFConv(Conv):
    """Spatial-frequency convolution (layers.py:194-270): a KxK spatial conv
    blended by sigmoid(sf_coef) with the frequency branch (a dense 1x1 conv
    over the packed 2C spectrum, evaluated in its exact spatial closed form by
    ``sfconv_freq``), average-pooled to the spatial output when strided.

    Parameter names follow the reference: ``weight`` (the spatial conv),
    ``freq_conv.weight`` (2C, 2C, 1, 1) and the scalar ``sf_coef``.

    The frequency branch runs K2 (``sfconv_freq``), or K3
    (``sfconv_freq_v4``) for a square input whose width is in ``v4_widths``
    and that the K2 gate of the JAX model does not take first
    (``sfconv_rowtiled.uses_v4``). ``registry.build_model`` reads its
    default from ``UD_SFCONV_V4``; here it defaults to none (K2
    everywhere)."""

    def __init__(self, channels: int, kernel_size: int, stride: int = 1,
                 padding: Padding = 0, groups: int = 1, bias: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 v4_widths: Iterable[int] = ()):
        super().__init__(channels, channels, kernel_size, stride, padding, groups, bias,
                         dtype=dtype)
        self.freq_conv = nn.Conv2d(2 * channels, 2 * channels, 1, bias=False)
        self.sf_coef = nn.Parameter(torch.tensor(-10.0))
        self.v4_widths = frozenset(v4_widths)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        spat = super().forward(x)
        xc = x.to(self.compute_dtype).contiguous(memory_format=torch.channels_last)
        # rows of w_packed are packed input channels: the (out, in) conv weight, transposed
        w_packed = self.freq_conv.weight[:, :, 0, 0].t()
        x_nhwc = nhwc(xc)
        branch = sfconv_freq_v4 if uses_v4(x_nhwc.shape, self.v4_widths) else sfconv_freq
        freq = branch(x_nhwc, w_packed).float()
        if freq.shape[1:3] != spat.shape[2:4]:
            freq = adaptive_avg_pool(freq, spat.shape[2], spat.shape[3])
        freq = nchw(freq).to(spat.dtype)
        coef = torch.sigmoid(self.sf_coef).to(spat.dtype)
        return (1.0 - coef) * spat + coef * freq


class ConvTranspose(nn.ConvTranspose2d):
    """torch ConvTranspose2d (k3, s2, p1, op1 in the decoders) computing in
    ``dtype`` (layers.py:273-314); weight layout (in, out, kh, kw)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, stride: int = 2,
                 padding: int = 1, output_padding: int = 1, bias: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_ch, out_ch, kernel_size, stride, padding, output_padding,
                         bias=bias)
        self.compute_dtype = optional_dtype(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), bias, self.stride,
                                  self.padding, self.output_padding)


class CDConv(Conv):
    """Central-difference convolution (layers.py:317-363):
    conv(x, W) - theta * conv(x, sum_kk(W) as a 1x1 kernel), the bias added
    to both convs as the reference's torch module adds it. No shipped model
    calls it; the JAX package defines it for API parity."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 padding: Padding = 0, theta: float = 0.7, bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_ch, out_ch, kernel_size, stride, padding, bias=bias, dtype=dtype)
        self.theta = theta

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = super().forward(x)
        if abs(self.theta) < 1e-8:
            return out
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        diff = self.weight.sum(dim=(2, 3), keepdim=True).to(dt)
        return out - self.theta * F.conv2d(x.to(dt), diff, bias, self.stride)


def conv_or_sfconv(use_sf: bool, in_ch: int, out_ch: int, kernel_size: int, stride: int,
                   padding: Padding, bias: bool = False, dtype: Optional[torch.dtype] = None,
                   v4_widths: Iterable[int] = ()) -> Conv:
    """An SFConv where the ResNet gate allows one (its in and out channels
    match), else a plain Conv (layers.py:366-372)."""
    if use_sf:
        if in_ch != out_ch:
            raise ValueError(f"an SFConv maps C to C channels, not {in_ch} to {out_ch}")
        return SFConv(out_ch, kernel_size, stride, padding, bias=bias, dtype=dtype,
                      v4_widths=v4_widths)
    return Conv(in_ch, out_ch, kernel_size, stride, padding, bias=bias, dtype=dtype)

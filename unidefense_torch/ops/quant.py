"""Weight-only int8 serving (unidefense_tpu/ops/quant.py:34-109).

Symmetric per-output-channel int8 for every parameter with ndim >= 2 (conv,
ConvTranspose and dense weights, the SFConv frequency convs):

    q     : int8, the weight's shape
    scale : float32, one per output channel, amax over the other axes / 127

The output axis is where the JAX package's last (output) axis lands through
``models/convert._layout``: 0 for a conv (O, I, kh, kw) and a dense (out,
in), 1 for a ConvTranspose (in, out, kh, kw). 1-D and 0-D parameters and
every buffer stay as they are, bit for bit. Serving dequantizes in the
compute dtype, ``q.to(dtype) * scale.to(dtype)``, as the JAX package does;
the rounding of a bf16 product differs from an fp32 one cast to bf16.

The JAX package does this outside any Pallas kernel (``jnp.round`` and a
multiply), so plain torch ops do it here.
"""

from __future__ import annotations

import torch
import torch.nn as nn


def out_channel_axis(module: nn.Module) -> int:
    """The axis of ``module.weight`` that holds its output channels."""
    if isinstance(module, nn.ConvTranspose2d):
        return 1
    if isinstance(module, (nn.Conv2d, nn.Linear)):
        return 0
    raise TypeError(f"no output-channel rule for the weight of a {type(module).__name__}")


def quantize_weight(w: torch.Tensor, axis: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale float32 of w.shape[axis]) of one weight."""
    w = w.detach().float()
    amax = w.abs().amax(dim=tuple(d for d in range(w.dim()) if d != axis), keepdim=True)
    # ``/ 127.0`` in the JAX source; XLA compiles the jitted quantize_tree's
    # division by that constant as a product with its fp32 reciprocal
    # (0.00787401572), which rounds differently for some amax
    scale = torch.clamp_min(amax, 1e-12) * torch.tensor(1.0 / 127.0, dtype=torch.float32)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale.reshape(-1)


def dequantize_weight(q: torch.Tensor, scale: torch.Tensor, axis: int,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q * scale`` computed in ``dtype``."""
    shape = [1] * q.dim()
    shape[axis] = -1
    return q.to(dtype) * scale.to(dtype).view(shape)


def serving_parameters(model: nn.Module):
    """(name, module, parameter) of every parameter the JAX package keeps in
    its ``params`` tree: those that train (``requires_grad``, the
    optimizer's rule). The bottleneck's frozen zero bias, a constant there,
    is left out."""
    for mod_name, module in model.named_modules():
        for name, p in module.named_parameters(recurse=False):
            if p.requires_grad:
                yield (f"{mod_name}.{name}" if mod_name else name), module, p


class Int8Weights:
    """The int8 form of a model's >= 2-D parameters, on the parameters'
    device, and the way back into the model: :meth:`dequantize_into`
    writes ``q * scale`` in ``dtype`` into the model's own weights, which
    the eval step then reads (the SFConv kernels split their blocks from the
    weight on every call and keep no copy)."""

    def __init__(self, model: nn.Module):
        self.weights = {}  # name -> (parameter, q, scale, axis)
        self.passthrough_bytes = 0
        for name, module, p in serving_parameters(model):
            if p.dim() >= 2:
                axis = out_channel_axis(module)
                self.weights[name] = (p, *quantize_weight(p, axis), axis)
            else:
                self.passthrough_bytes += p.numel() * p.element_size()

    @torch.no_grad()
    def dequantize_into(self, dtype: torch.dtype) -> None:
        for p, q, scale, axis in self.weights.values():
            p.copy_(dequantize_weight(q, scale, axis, dtype))

    def nbytes(self) -> int:
        """Bytes as stored: int8 values, fp32 scales, the 1-D and 0-D
        parameters as they are (``tree_nbytes``)."""
        return self.passthrough_bytes + sum(q.numel() + 4 * s.numel()
                                            for _, q, s, _ in self.weights.values())


def param_bytes(model: nn.Module) -> int:
    """Bytes of the parameters the JAX package's ``params`` tree holds."""
    return sum(p.numel() * p.element_size() for _, _, p in serving_parameters(model))

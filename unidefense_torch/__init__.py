"""PyTorch / CUDA port of unidefense_tpu for NVIDIA Hopper (H100).

The module layout mirrors the JAX package so each counterpart is easy to
find. Tensors inside the models are NCHW in ``torch.channels_last`` memory
format, so ``x.permute(0, 2, 3, 1)`` is a free contiguous NHWC view; the
op-level functions (``ops/``) take NHWC like their JAX counterparts.

Every Pallas kernel of the JAX package on the ported path is a CUDA C++
kernel under ``csrc/`` (built by ``ops/_build.py``), with a plain PyTorch
version beside it that CPU tensors use.
"""

from unidefense_torch.device import resolve_device

__all__ = ["resolve_device"]

"""Seeded weights: one state dict for the program and the reference, made on
the device from ``--seed`` in a few large calls.

Every tensor's name and shape come from the reference model built on the
``meta`` device (its names are the program's). One standard normal draw of
all the weights' elements is cut into the tensors and scaled by a rule of
the configuration's ``assumed.init``:

- a convolution or deconvolution kernel: std sqrt(1 / fan in), with fan in
  the product of its dimensions after the first;
- a linear layer's weight (the classifier): ``linear_std``;
- a BatchNorm's scale ``bn_scale``, and ``residual_bn_scale`` on the last
  BatchNorm of every residual branch (``residual_bn``, a pattern of module
  names): a small residual branch, so that the random network does not
  amplify rounding from block to block; an InstanceNorm's scale 1;
- every bias 0, ``fuse_coef`` 0, and ``sf_coef`` the value ``sf_coef`` (0
  blends the SFConv frequency branch in by one half, where the init's -10
  would leave it out of every comparison);
- running statistics 0 and 1, or, with ``calibrate``, those the reference
  measures in float32 on seeded frames (``calibrate_frames`` of them), as a
  served model's are, and the classifier scaled so that the gap of the two
  logits has the root mean square ``logit_gap_rms`` on those frames.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from perfbench.reference import model as ref_model
from perfbench.reference.numerics import Numerics


def sub_seed(seed: int, *tags) -> int:
    """A 31-bit seed for the stream ``tags`` of run seed ``seed``."""
    words = [int(seed) & 0xFFFFFFFF, int(seed) >> 32]
    for t in tags:
        words.append(sum(ord(ch) * 31 ** i for i, ch in enumerate(t)) & 0xFFFFFFFF
                     if isinstance(t, str) else int(t))
    return int(np.random.SeedSequence(words).generate_state(1, np.uint32)[0] >> np.uint32(1))


def generator(seed: int, device, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *tags))


def frames(n: int, size: int, gen: torch.Generator, device) -> torch.Tensor:
    """``n`` seeded uint8 frames (N, size, size, 3), each its own picture: a
    smooth colour field (8 x 8 values, bilinear) at a brightness, contrast
    and grain of its own, drawn in a few calls on ``gen``'s device. Frames of
    one i.i.d. noise look alike to the network: their pooled features differ
    by less than a bfloat16 step, which a train-mode or calibrated BatchNorm
    over frames then magnifies into one shift of every frame's logits."""
    import torch.nn.functional as F

    dev = gen.device
    field = F.interpolate(torch.rand((n, 3, 8, 8), generator=gen, device=dev), size=(size, size),
                          mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
    grain = torch.rand((n, size, size, 3), generator=gen, device=dev)
    level, contrast, noise = torch.rand((3, n, 1, 1, 1), generator=gen, device=dev)
    img = 0.2 + 0.6 * level + (0.3 + 1.2 * contrast) * (field - 0.5) \
        + (0.05 + 0.45 * noise) * (grain - 0.5)
    return (img.clamp(0.0, 1.0) * 255.0).round().to(torch.uint8).to(device).contiguous()


def _is_bn(name: str, sd: dict) -> bool:
    return name.rsplit(".", 1)[0] + ".running_mean" in sd


def make_state_dict(config: dict, seed: int, device) -> dict:
    """The weights of ``config``'s model for run seed ``seed`` (see above)."""
    init = config["assumed"]["init"]
    shapes = {k: (tuple(v.shape), v.dtype)
              for k, v in ref_model.meta(config["model"]).state_dict().items()}
    residual = re.compile(init["residual_bn"])
    weights = [k for k, (shape, dt) in shapes.items() if dt.is_floating_point and len(shape) >= 2]
    total = sum(int(np.prod(shapes[k][0])) for k in weights)
    flat = torch.randn(total, generator=generator(seed, device, "weights"), device=device)
    sd, at = {}, 0
    for k in weights:
        shape = shapes[k][0]
        n = int(np.prod(shape))
        sd[k] = flat[at:at + n].view(shape)
        at += n
    scales = [init["linear_std"] if len(shapes[k][0]) == 2 else
              float(np.prod(shapes[k][0][1:])) ** -0.5 for k in weights]
    torch._foreach_mul_([sd[k] for k in weights], scales)
    for k, (shape, dt) in shapes.items():
        if k in sd:
            continue
        leaf = k.rsplit(".", 1)[-1]
        if leaf == "weight":  # a norm's scale
            module = k.rsplit(".", 1)[0]
            value = 1.0
            if _is_bn(k, shapes):
                value = init["residual_bn_scale"] if residual.fullmatch(module) \
                    else init["bn_scale"]
        elif leaf in ("running_var",):
            value = 1.0
        elif leaf == "sf_coef":
            value = init["sf_coef"]
        else:  # biases, fuse_coef, running means, batch counts
            value = 0.0
        sd[k] = torch.full(shape, value, dtype=dt, device=device)
    return sd


@torch.no_grad()
def calibrate(config: dict, sd: dict, seed: int, device, size: int, count: int) -> dict:
    """``sd`` with every BatchNorm's running statistics set from one float32
    eval forward of the reference on ``count`` seeded frames, and the
    classifier scaled (see above)."""
    from perfbench.reference.train import normalize

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        ref = ref_model.build(config["model"], Numerics(), sd, device)
        ref.eval()
        for m in ref.modules():
            if isinstance(m, ref_model.BatchNorm):
                m.calibrate = True
        u8 = frames(count, size, generator(seed, device, "calibration frames"), device)
        x = ref_model.nchw(normalize(u8))
        ref(x)
        for m in ref.modules():
            if isinstance(m, ref_model.BatchNorm):
                m.calibrate = False
        logits = ref(x)["cls_out"]
        gap = (logits[:, 0] - logits[:, 1]).pow(2).mean().sqrt()
        ref.classifier.fc.weight.mul_(config["assumed"]["init"]["logit_gap_rms"] / gap)
        out = {k: v.detach().clone() for k, v in ref.state_dict().items()}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return out
